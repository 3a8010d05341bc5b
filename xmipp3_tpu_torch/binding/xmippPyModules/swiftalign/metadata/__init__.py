from xmipp3_tpu_torch.binding.xmippPyModules.swiftalign.metadata.labels import *  # noqa: F401,F403
from xmipp3_tpu_torch.binding.xmippPyModules.swiftalign.metadata.read import read
from xmipp3_tpu_torch.binding.xmippPyModules.swiftalign.metadata.utils import sort_by_image_filename
from xmipp3_tpu_torch.binding.xmippPyModules.swiftalign.metadata.write import write
