"""Stand-in for the root `xmipp_base`: `import xmipp_base` with this
directory ahead on PYTHONPATH loads the port's binding,
xmipp3_tpu_torch/binding/xmipp_base.py."""
from _xmipp_port_site import port_module

port_module(__name__, "xmipp3_tpu_torch.binding.xmipp_base")
