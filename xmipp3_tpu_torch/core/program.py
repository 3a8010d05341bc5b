"""Program framework: the declarative CLI grammar + program lifecycle.

Rebuilds the xmippCore XmippProgram/XmippMetadataProgram contract (SURVEY.md
§1.1, §3.1): programs declare parameters in `defineParams()` with the same
string DSL the reference uses in 1848 addParamsLine calls (e.g.
the reference's reconstruction/reconstruct_fourier.cpp:36-62,
data/fourier_filter.cpp defineParams with `where` choice blocks), then
`read(argv)` parses, `tryRun()` wraps `run()` in typed-error handling.

Grammar elements supported (observed from reference usage):
    == Section ==                       cosmetic grouping
    -x <a> <b=dflt> : comment           required param, args with defaults
    [-x ...]                            optional param
    [--flag]                            boolean flag
    <...>                               variable-length tail argument
    where <argname> / choice <args> :   enumerated argument with per-choice
                                        sub-arguments (token-count driven)
    alias -y;   requires --z;           param aliases / dependencies
    : continuation comment (":+" = verbose-only)

Token consumption is count-driven (not '-'-prefix driven) so negative numeric
values parse without escaping, matching reference behavior.
"""
from __future__ import annotations

import re
import shlex
import sys
from dataclasses import dataclass, field

from xmipp3_tpu_torch.core.errors import ErrCode, XmippError


# ---------------------------------------------------------------------------
# grammar model
# ---------------------------------------------------------------------------

@dataclass
class ArgDef:
    name: str
    default: str | None = None
    is_rest: bool = False                       # <...>
    choices: dict[str, list["ArgDef"]] = field(default_factory=dict)

    @property
    def has_default(self) -> bool:
        return self.default is not None


@dataclass
class ParamDef:
    name: str
    args: list[ArgDef] = field(default_factory=list)
    optional: bool = False
    comment: str = ""
    aliases: list[str] = field(default_factory=list)
    requires: list[str] = field(default_factory=list)
    section: str = ""

    def all_names(self) -> list[str]:
        return [self.name] + self.aliases


_ARG_RE = re.compile(r"<([^<>=]*)(?:=((?:[^<>\"]|\"[^\"]*\")*))?>")


def _parse_args_spec(spec: str) -> list[ArgDef]:
    out = []
    for m in _ARG_RE.finditer(spec):
        name = m.group(1).strip()
        default = m.group(2)
        if default is not None:
            default = default.strip().strip('"')
        if name == "..." or name == "":
            out.append(ArgDef("...", is_rest=True))
        else:
            out.append(ArgDef(name, default))
    return out


class ParamsGrammar:
    """Accumulates addParamsLine declarations and parses command lines."""

    def __init__(self):
        self.params: dict[str, ParamDef] = {}     # canonical name -> def
        self.order: list[str] = []
        self._alias_map: dict[str, str] = {}
        self._last_param: ParamDef | None = None
        self._where_arg: ArgDef | None = None
        self._last_choice: str | None = None
        self._choice_requires: dict[tuple[str, str], list[str]] = {}
        self._section = ""

    # -- declaration ----------------------------------------------------
    def add_line(self, line: str) -> None:
        s = line.strip()
        if not s:
            return
        if s.startswith("=="):
            self._section = s.strip("= ").strip()
            self._where_arg = None
            return
        if s.startswith(":"):
            # continuation comment: attach to last param (":+": verbose help)
            if self._last_param is not None:
                self._last_param.comment += "\n" + s.lstrip(":+ ")
            return
        if s.startswith("alias"):
            body = s[len("alias"):].strip().rstrip(";").strip()
            if self._last_param is not None:
                for a in body.split():
                    self._last_param.aliases.append(a)
                    self._alias_map[a] = self._last_param.name
            return
        if s.startswith("requires"):
            body = s[len("requires"):].strip().rstrip(";").strip()
            if self._where_arg is not None and self._last_choice is not None:
                # choice-scoped dependency (e.g. "bfactor ... requires --sampling")
                self._choice_requires.setdefault(
                    (self._last_param.name, self._last_choice), []).extend(
                        body.split())
            elif self._last_param is not None:
                self._last_param.requires.extend(body.split())
            return
        if s.startswith("where"):
            argname = s[len("where"):].strip().strip("<>").strip()
            self._where_arg = None
            if self._last_param is not None:
                for a in self._last_param.args:
                    if a.name == argname:
                        self._where_arg = a
            return
        # comment split
        comment = ""
        # find ':' that is not inside <...=...>
        depth = 0
        for i, ch in enumerate(s):
            if ch == "<":
                depth += 1
            elif ch == ">":
                depth -= 1
            elif ch == ":" and depth == 0:
                comment = s[i + 1:].strip()
                s = s[:i].strip()
                break
        if not s:
            if self._last_param is not None and comment:
                self._last_param.comment += "\n" + comment
            return
        if s.startswith("[") or s.startswith("-"):
            self._where_arg = None
            optional = s.startswith("[")
            body = s.strip("[]").strip() if optional else s
            toks = body.split(None, 1)
            name = toks[0].rstrip("+")  # '+' marks advanced params in the DSL
            args = _parse_args_spec(toks[1]) if len(toks) > 1 else []
            p = ParamDef(name, args, optional, comment, section=self._section)
            self.params[name] = p
            self.order.append(name)
            self._last_param = p
            return
        if self._where_arg is not None:
            # choice line: "choicename <a> <b=d> : comment".  The reference
            # DSL also allows several bare sibling choices on one line
            # ("DAUB4 DAUB12 DAUB20 : ..."), all sharing the arg spec.
            toks = s.split()
            names = []
            while toks and not toks[0].startswith("<"):
                names.append(toks.pop(0))
            spec = _parse_args_spec(" ".join(toks)) if toks else []
            for choice in names or [""]:
                self._where_arg.choices[choice] = spec
                self._last_choice = choice
            return
        # free text — treat as usage comment
        if self._last_param is not None and comment:
            self._last_param.comment += "\n" + comment

    def canonical(self, name: str) -> str | None:
        if name in self.params:
            return name
        return self._alias_map.get(name)

    # -- command-line parsing -------------------------------------------
    def parse(self, tokens: list[str]) -> dict[str, list[str]]:
        values: dict[str, list[str]] = {}
        i = 0
        n = len(tokens)

        def is_option(tok: str) -> bool:
            return self.canonical(tok) is not None

        def consume_args(argdefs: list[ArgDef], i: int, out: list[str],
                         pname: str) -> int:
            for a in argdefs:
                if a.is_rest:
                    while i < n and not is_option(tokens[i]):
                        out.append(tokens[i])
                        i += 1
                    continue
                if i < n and not is_option(tokens[i]):
                    tok = tokens[i]
                    i += 1
                else:
                    if a.has_default:
                        tok = a.default
                    else:
                        raise XmippError(
                            ErrCode.ARG_MISSING,
                            f"param {pname}: missing argument <{a.name}>")
                out.append(tok)
                if a.choices:
                    if tok not in a.choices:
                        raise XmippError(
                            ErrCode.ARG_INCORRECT,
                            f"param {pname}: '{tok}' not a valid <{a.name}> "
                            f"(choices: {', '.join(a.choices)})")
                    i = consume_args(a.choices[tok], i, out, pname)
            return i

        while i < n:
            tok = tokens[i]
            cname = self.canonical(tok)
            if cname is None:
                raise XmippError(ErrCode.ARG_BADCMDLINE,
                                 f"unexpected token '{tok}'")
            i += 1
            out: list[str] = []
            i = consume_args(self.params[cname].args, i, out, cname)
            values[cname] = out

        # required params present?
        for name, p in self.params.items():
            if not p.optional and name not in values:
                raise XmippError(ErrCode.ARG_MISSING, f"param {name} not found")
        # dependencies (param-level and choice-level)
        for name in list(values):
            if name == "__defaults__":
                continue
            for req in self.params[name].requires:
                if self.canonical(req) not in values:
                    raise XmippError(ErrCode.ARG_MISSING,
                                     f"param {name} requires {req}")
            toks = set(values[name])
            for (pname, choice), reqs in self._choice_requires.items():
                if pname == name and choice in toks:
                    for req in reqs:
                        if self.canonical(req) not in values:
                            raise XmippError(
                                ErrCode.ARG_MISSING,
                                f"param {name} {choice} requires {req}")
        # defaults for absent optional params (so getParam works uniformly)
        for name, p in self.params.items():
            if name not in values and p.args and all(
                    a.has_default for a in p.args if not a.is_rest):
                out = []
                for a in p.args:
                    if a.is_rest:
                        continue
                    out.append(a.default)
                    if a.choices and a.default in a.choices:
                        out.extend(x.default or "" for x in a.choices[a.default])
                values.setdefault("__defaults__", []).append(name)
                values[name] = out
        return values

    # -- help -----------------------------------------------------------
    def usage(self) -> str:
        lines = []
        section = None
        for name in self.order:
            p = self.params[name]
            if p.section != section:
                section = p.section
                if section:
                    lines.append(f"\n == {section} ==")
            argspec = " ".join(
                f"<{a.name}{'=' + a.default if a.has_default else ''}>"
                if not a.is_rest else "<...>" for a in p.args)
            head = f"{name} {argspec}".strip()
            head = f"[{head}]" if p.optional else f" {head} "
            first_comment = p.comment.split("\n")[0]
            lines.append(f"   {head:<44} : {first_comment}")
            for extra in p.comment.split("\n")[1:]:
                lines.append(f"   {'':<44} : {extra}")
            for a in p.args:
                for c, cargs in a.choices.items():
                    cspec = " ".join(
                        f"<{x.name}{'=' + x.default if x.has_default else ''}>"
                        for x in cargs)
                    lines.append(f"       where <{a.name}> {c} {cspec}")
            if p.aliases:
                lines.append(f"   {'':<44} : alias {', '.join(p.aliases)}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# XmippProgram
# ---------------------------------------------------------------------------

class XmippProgram:
    """Base program: declarative params + read/tryRun lifecycle."""

    name = "xmipp_program"

    def __init__(self):
        self._grammar = ParamsGrammar()
        self._usage_lines: list[str] = []
        self._example_lines: list[str] = []
        self._values: dict[str, list[str]] = {}
        self.verbose = 1
        self._define_standard_params()
        self.defineParams()

    # -- declaration API (same names as the reference) -------------------
    def addUsageLine(self, line: str, verbatim: bool = False) -> None:
        self._usage_lines.append(line)

    def addParamsLine(self, line: str) -> None:
        self._grammar.add_line(line)

    def addExampleLine(self, line: str, verbatim: bool = True) -> None:
        self._example_lines.append(line)

    def addSeeAlsoLine(self, line: str) -> None:
        self._usage_lines.append("See also: " + line)

    def addKeywords(self, line: str) -> None:
        pass

    def _define_standard_params(self) -> None:
        self.addParamsLine("  [-v+ <verbosity_level=1>] : Verbosity level")
        self._grammar.add_line("     alias --verbose;")
        self.addParamsLine("  [--gpu <...>]       : Accepted for CLI compat; "
                           "the card is chosen with --device")
        self.addParamsLine("  [--device <dev=default>] : torch device, e.g. "
                           "cuda, cuda:1 or cpu (default: cuda)")
        self._grammar.add_line("     alias --dev;")
        self.addParamsLine("  [--thr <threads=1> <rows=1>] : Host worker threads "
                           "(I/O pipelining); device parallelism is automatic")
        self._grammar.add_line("     alias --threads --nThreads;")
        self.addParamsLine("  [--trace <dir=\"\">]  : Write a torch.profiler "
                           "Chrome trace of the run to this directory; "
                           "-v 2 adds phase timing")

    # -- to override ------------------------------------------------------
    def defineParams(self) -> None:
        pass

    def readParams(self) -> None:
        pass

    def run(self) -> None:
        raise XmippError(ErrCode.NOT_IMPLEMENTED, self.name)

    def show(self) -> None:
        pass

    # -- lifecycle --------------------------------------------------------
    def read(self, argv: list[str]) -> None:
        if argv and not argv[0].startswith("-"):
            self.name = argv[0].split("/")[-1]
            argv = argv[1:]
        if any(a in ("-h", "--help", "--help+") for a in argv):
            try:
                print(self.usage())
            except BrokenPipeError:   # e.g. `xmipp prog --help | head`
                pass
            self._help_requested = True
            return
        self._help_requested = False
        self._values = self._grammar.parse(list(argv))
        if self.checkParam("-v"):
            self.verbose = self.getIntParam("-v")
        self.readParams()

    def tryRun(self) -> int:
        if getattr(self, "_help_requested", False):
            return 0
        try:
            from xmipp3_tpu_torch.core.timing import enable_timing, trace
            if self.verbose >= 2:
                enable_timing(True)
            trace_dir = (self.getParam("--trace")
                         if self.checkParam("--trace") else "")
            self.show_if_verbose()
            with trace(trace_dir):
                self.run()
            return 0
        except XmippError as e:
            print(f"XMIPP_ERROR: {e}", file=sys.stderr)
            return 1
        except (FileNotFoundError, PermissionError, IsADirectoryError) as e:
            print(f"XMIPP_ERROR: {ErrCode.IO_NOTEXIST.name}: {e}",
                  file=sys.stderr)
            return 1
        except BrokenPipeError:   # stdout consumer closed (e.g. `| head`)
            return 0

    def show_if_verbose(self):
        if self.verbose:
            try:
                self.show()
            except Exception:
                pass

    # -- runtime param access (reference API) -----------------------------
    def checkParam(self, name: str) -> bool:
        c = self._grammar.canonical(name)
        if c is None:
            return False
        if c in self._values:
            return c not in self._values.get("__defaults__", [])
        return False

    def _get(self, name: str, idx: int) -> str:
        c = self._grammar.canonical(name)
        if c is None or c not in self._values:
            raise XmippError(ErrCode.ARG_MISSING, name)
        vals = self._values[c]
        if idx >= len(vals):
            raise XmippError(ErrCode.ARG_MISSING, f"{name} arg {idx}")
        return vals[idx]

    def getParam(self, name: str, idx: int = 0) -> str:
        return self._get(name, idx)

    def refuse_unread(self, *names: str, item: int) -> None:
        """Raise for any of `names` given with a value other than its
        default: flags that the reference declares and never reads, which
        the port refuses rather than ignore (ROADMAP.md section 3, item
        `item`). A flag without arguments is refused whenever it is
        given."""
        for name in names:
            if not self.checkParam(name):
                continue
            args = self._grammar.params[self._grammar.canonical(name)].args
            same = bool(args)
            for k, a in enumerate(args):
                got = self._get(name, k)
                try:
                    same &= float(got) == float(a.default)
                except (TypeError, ValueError):
                    same &= got == a.default
            if not same:
                raise XmippError(
                    ErrCode.ARG_INCORRECT,
                    f"{name}: the reference accepts this flag and never "
                    f"reads it; the port refuses it rather than ignore it "
                    f"(ROADMAP.md section 3, item {item})")

    def getIntParam(self, name: str, idx: int = 0) -> int:
        return int(float(self._get(name, idx)))

    def getDoubleParam(self, name: str, idx: int = 0) -> float:
        return float(self._get(name, idx))

    def getListParam(self, name: str) -> list[str]:
        c = self._grammar.canonical(name)
        if c is None or c not in self._values:
            return []
        return list(self._values[c])

    # -- help -------------------------------------------------------------
    def usage(self) -> str:
        parts = [f"PROGRAM\n   {self.name}\n"]
        if self._usage_lines:
            parts.append("USAGE\n" + "\n".join(
                f"   {u}" for u in self._usage_lines) + "\n")
        parts.append("OPTIONS\n" + self._grammar.usage())
        if self._example_lines:
            parts.append("\nEXAMPLES\n" + "\n".join(
                f"   {e}" for e in self._example_lines))
        return "\n".join(parts)

    # convenience for tests / python use
    def run_with_args(self, args: str | list[str]) -> int:
        if isinstance(args, str):
            args = shlex.split(args)
        self.read([self.name] + args)
        return self.tryRun()
