"""xmippPyModules on the port — importable Python module surface.

Mirrors the reference's `libraries/py_xmipp` package layout
(reference src/xmipp/libraries/py_xmipp/: swiftalign, classifyPcaFuntion,
coordinatesTools, deepLearningToolkitUtils, example_module) on the port's
ops: what reaches an op runs on the card unless `device="cpu"` is given;
the rest is host numpy.
"""
