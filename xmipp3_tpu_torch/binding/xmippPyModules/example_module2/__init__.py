"""Example importable subpackage (reference py_xmipp/example_module2)."""
