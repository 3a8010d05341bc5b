"""Stand-in for the root `xmippPyModules` package: with this directory
ahead on PYTHONPATH, `xmippPyModules` and every `xmippPyModules.<sub>`
name the port's modules under xmipp3_tpu_torch/binding/xmippPyModules/
(one module object a name: the aliases and the port's full names share
it)."""
import importlib
import importlib.abc
import importlib.util
import sys

from _xmipp_port_site import port_module

_PORT = "xmipp3_tpu_torch.binding.xmippPyModules"


class _PortAlias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Finds `xmippPyModules.<sub>` as the port's `<_PORT>.<sub>`."""

    def find_spec(self, name, path=None, target=None):
        if name.startswith(__name__ + "."):
            port = _PORT + name[len(__name__):]
            if importlib.util.find_spec(port) is not None:
                return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        return importlib.import_module(_PORT + spec.name[len(__name__):])

    def exec_module(self, module):
        pass


if not any(isinstance(f, _PortAlias) for f in sys.meta_path):
    sys.meta_path.insert(0, _PortAlias())
port_module(__name__, _PORT)
