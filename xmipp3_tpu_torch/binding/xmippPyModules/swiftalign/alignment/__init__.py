from xmipp3_tpu_torch.binding.xmippPyModules.swiftalign.alignment.InPlaneTransformCorrector import \
    InPlaneTransformCorrector
