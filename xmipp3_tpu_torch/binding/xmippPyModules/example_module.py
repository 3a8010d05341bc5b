"""Example importable module (reference py_xmipp/example_module.py role):
demonstrates that user scripts can `import xmippPyModules` and reach the
framework. The anyFunction/anyClass surface is the import contract that
xmipp_test_script_importing_module exercises."""


def axis_angle_example():
    return "xmippPyModules is importable"


def anyFunction():
    return "returningFromFunction"


class anyClass:

    A_CONSTANT = "A class constant."

    def __init__(self):
        self.inVar = "An object var."

    @classmethod
    def getFromClassMethod(cls):
        return "Getting '%s'" % cls.A_CONSTANT

    def getFromObjectMethod(self):
        return "Getting '%s'" % self.inVar
