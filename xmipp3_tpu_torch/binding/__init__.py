"""The port's binding surface: what a Scipion-style script imports.

`xmippLib` (the reference's Python binding: FileName, Image, MetaData,
SymList, Program, FourierProjector, the MDL_* labels and the free
functions), `xmipp_base` (XmippScript, CondaEnvManager, XmippMdRow and the
metadata helpers) and the `xmippPyModules` tree (swiftalign,
classifyPcaFuntion, coordinatesTools, deepLearningToolkitUtils and the
example modules), with the names and signatures of the root modules of
the same name. Host-only code stays host numpy; every function that
reaches an op runs it on the card unless the caller passes
`device="cpu"`, and raises when no card is visible.

`site/` stands in for the root modules: with
`<repo>/xmipp3_tpu_torch/binding/site` ahead on PYTHONPATH, `import
xmippLib`, `import xmipp_base` and `from xmippPyModules... import ...`
load these modules. `matlab/` holds the MATLAB/Octave wrappers, which
call `xmipp_torch matlab_bridge`.
"""
