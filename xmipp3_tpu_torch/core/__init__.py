from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.filename import FileName, as_filename
from xmipp3_tpu_torch.core.metadata import MetaData, Row, compare_two_metadata_files
from xmipp3_tpu_torch.core.image import Image, load_image, save_image
