from xmipp3_tpu_torch.binding.xmippPyModules.swiftalign.classification.aligned_2d_classification \
    import aligned_2d_classification
