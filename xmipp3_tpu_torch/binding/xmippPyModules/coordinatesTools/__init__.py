from xmipp3_tpu_torch.binding.xmippPyModules.coordinatesTools.coordinatesTools import (
    readPosCoordsFromFName, writeCoordsListToPosFname)
