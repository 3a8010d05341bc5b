from xmipp3_tpu_torch.binding.xmippPyModules.swiftalign.ctf.compute_ctf_image_2d import \
    compute_ctf_image_2d
from xmipp3_tpu_torch.binding.xmippPyModules.swiftalign.ctf.wiener import wiener_2d
