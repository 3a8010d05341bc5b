"""CLI program endpoints of the port (the xmipp_<name> surface).

`main()` is the dispatcher: `python -m xmipp3_tpu_torch.programs <program>
[args...]`, or through a symlink/alias named `xmipp_<program>`. Programs
run on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import os
import sys

# program name -> module path (module's PROGRAM attribute)
_REGISTRY: dict[str, str] = {
    "reconstruct_fourier": "xmipp3_tpu_torch.programs.reconstruct_fourier",
}


def get_program(name: str):
    """Instantiate a program class by CLI name (lazy import)."""
    import importlib

    if name not in _REGISTRY:
        return None
    return importlib.import_module(_REGISTRY[name]).PROGRAM()


def list_programs() -> list[str]:
    return sorted(_REGISTRY)


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    prog = os.path.basename(argv[0])
    if prog.startswith("xmipp_"):
        name, args = prog[len("xmipp_"):], argv[1:]
    else:
        if len(argv) < 2 or argv[1] in ("-h", "--help"):
            print("Usage: python -m xmipp3_tpu_torch.programs <program> "
                  "[options]\n\nAvailable programs:")
            for p in list_programs():
                print(f"  xmipp_{p}")
            return 0
        name, args = argv[1], argv[2:]
        if name.startswith("xmipp_"):
            name = name[len("xmipp_"):]
    program = get_program(name)
    if program is None:
        print(f"xmipp: unknown program '{name}' (try --help)",
              file=sys.stderr)
        return 1
    from xmipp3_tpu_torch.core.errors import XmippError
    try:
        program.read(["xmipp_" + name] + args)
    except XmippError as e:
        print(f"XMIPP_ERROR: {e}\nRun 'xmipp_{name} --help' for usage.",
              file=sys.stderr)
        return 1
    return program.tryRun()
