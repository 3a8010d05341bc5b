"""swiftalign on the port — alignment toolkit (importable).

Mirrors the reference's torch-based package
(libraries/py_xmipp/swiftalign/, 38 files) submodule-for-submodule on the
port's ops (card by default) and numpy: metadata (pandas STAR IO), image,
fourier, transform, ctf, operators, alignment, classification, utils.
"""
