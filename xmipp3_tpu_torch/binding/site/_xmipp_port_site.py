"""Shared by the stand-in modules of this directory: make the port's
package importable (the checkout that holds this directory, when the port
is not installed) and alias a stand-in's name to the port's module."""
from __future__ import annotations

import importlib
import importlib.util
import os
import sys


def port_module(name: str, port_name: str):
    """Import the port's module `port_name` and register it as `name`, so
    that `import <name>` yields the port's module object itself."""
    if importlib.util.find_spec("xmipp3_tpu_torch") is None:
        sys.path.append(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))))
    module = importlib.import_module(port_name)
    sys.modules[name] = module
    return module
