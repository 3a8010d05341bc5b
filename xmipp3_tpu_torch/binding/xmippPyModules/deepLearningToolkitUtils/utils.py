"""Deep-learning toolkit availability helpers.

Reference role (py_xmipp/deepLearningToolkitUtils/utils.py): check that
the conda DLTK env providing TF/torch is installed before running deep
programs. Here the deep_* programs run on torch.nn in this environment,
so the checks report torch and the card instead of probing conda
environments."""
from __future__ import annotations


def checkIf_tf_keras_installed():
    """torch.nn replaces TF-Keras in the port; succeeds when torch
    imports."""
    import torch  # noqa: F401
    return True


def checkIf_pytorch_installed():
    import torch  # noqa: F401
    return True


def getDeviceInfo():
    """The device the deep programs default to: the card when one is
    visible ({"platform": "gpu", "device_count", "name"}), else the CPU."""
    import torch
    if not torch.cuda.is_available():
        return {"platform": "cpu", "device_count": 0}
    return {"platform": "gpu", "device_count": torch.cuda.device_count(),
            "name": torch.cuda.get_device_name(0)}
