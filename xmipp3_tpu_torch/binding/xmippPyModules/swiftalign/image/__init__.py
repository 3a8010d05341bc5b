from xmipp3_tpu_torch.binding.xmippPyModules.swiftalign.image.Path import Path, parse_path
from xmipp3_tpu_torch.binding.xmippPyModules.swiftalign.image.read import read, read_data
from xmipp3_tpu_torch.binding.xmippPyModules.swiftalign.image.write import write
