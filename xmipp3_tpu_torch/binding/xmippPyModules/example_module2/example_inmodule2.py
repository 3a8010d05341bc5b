"""Example module inside a subpackage (reference
py_xmipp/example_module2/example_inmodule2.py role)."""


def anyFunction2():
    return "returningFromFunction (II)"


class anyClass2:

    A_CONSTANT = "A class constant. (II)"

    def __init__(self):
        self.inVar = "An object var. (II)"

    @classmethod
    def getFromClassMethod2(cls):
        return "Getting '%s'" % cls.A_CONSTANT

    def getFromObjectMethod2(self):
        return "Getting '%s'" % self.inVar
