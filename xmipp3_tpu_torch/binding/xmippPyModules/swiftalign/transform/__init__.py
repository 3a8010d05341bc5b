from xmipp3_tpu_torch.binding.xmippPyModules.swiftalign.transform.affine_2d import affine_2d
from xmipp3_tpu_torch.binding.xmippPyModules.swiftalign.transform.affine_matrix_2d import \
    affine_matrix_2d
from xmipp3_tpu_torch.binding.xmippPyModules.swiftalign.transform.euler_to_matrix import \
    euler_to_matrix
from xmipp3_tpu_torch.binding.xmippPyModules.swiftalign.transform.euler_to_quaternion import \
    euler_to_quaternion
from xmipp3_tpu_torch.binding.xmippPyModules.swiftalign.transform.matrix_to_euler import \
    matrix_to_euler
from xmipp3_tpu_torch.binding.xmippPyModules.swiftalign.transform.quaternion_arithmetic import (
    quaternion_conj, quaternion_product)
from xmipp3_tpu_torch.binding.xmippPyModules.swiftalign.transform.quaternion_to_matrix import \
    quaternion_to_matrix
