"""STAR / .xmd codec (the XMIPP_STAR_1 dialect).

Contract pinned by reference fixtures:
  the reference's resources/test/metadata/mDsource.xmd (loop block),
  .../ReadWriteAppendBlock.xmd (multiple blocks), .../sampling/ref_sampling.xmd
  (key-value "row format" block + empty loop blocks).

Grammar:
  header comment lines starting with '#' (first is '# XMIPP_STAR_1 * ');
  'data_<name>' opens a block; a block is either
    row format:   ' _label value' lines (one object), or
    column format: 'loop_' + ' _label' lines + whitespace-separated data rows.
Values: int / float / string; vector labels serialize bracketed
"[v1 v2 ...]"; strings with spaces may be single-quoted.
"""
from __future__ import annotations

import io
import re
from dataclasses import dataclass, field

import numpy as np
import pandas as pd

from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.labels import ALIASES, LabelType, label_type

STAR_HEADER = "# XMIPP_STAR_1 * "


@dataclass
class StarBlock:
    name: str
    df: pd.DataFrame
    row_format: bool = False  # True = key/value single-object block


def _parse_value(tok: str):
    """Infer int/float/str from a token."""
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok


_VEC_RE = re.compile(r"^\[(.*)\]$")


def _tokenize_row(line: str) -> list:
    """Split a data row into tokens, honoring '...' quoting and [v1 v2] vectors."""
    out, i, n = [], 0, len(line)
    while i < n:
        c = line[i]
        if c.isspace():
            i += 1
            continue
        if c == "'":
            j = line.find("'", i + 1)
            if j < 0:
                raise XmippError(ErrCode.MD_BADLABEL, f"unterminated quote: {line}")
            out.append(line[i + 1:j])
            i = j + 1
        elif c == "[":
            j = line.find("]", i)
            if j < 0:
                raise XmippError(ErrCode.MD_BADLABEL, f"unterminated vector: {line}")
            body = line[i + 1:j].replace(",", " ")
            out.append(np.array([float(t) for t in body.split()]))
            i = j + 1
        else:
            j = i
            while j < n and not line[j].isspace():
                j += 1
            out.append(_parse_value(line[i:j]))
            i = j
    return out


def parse_star(text: str) -> list[StarBlock]:
    blocks: list[StarBlock] = []
    lines = text.splitlines()
    i, n = 0, len(lines)

    def skip_blank_comments(i):
        while i < n and (not lines[i].strip() or lines[i].lstrip().startswith("#")):
            i += 1
        return i

    i = skip_blank_comments(i)
    while i < n:
        line = lines[i].strip()
        if not line.startswith("data_"):
            i += 1
            continue
        name = line[len("data_"):]
        i = skip_blank_comments(i + 1)
        # Decide block style
        if i < n and lines[i].strip() == "loop_":
            i += 1
            labels: list[str] = []
            while i < n:
                s = lines[i].strip()
                if s.startswith("_"):
                    labels.append(ALIASES.get(s.split()[0][1:], s.split()[0][1:]))
                    i += 1
                elif s.startswith("#") or not s:
                    i += 1
                    # blank after labels may end an empty loop block
                    if not s and labels:
                        break
                else:
                    break
            start = i
            has_special = False
            while i < n:
                s = lines[i].strip()
                if not s or s.startswith("#") or s.startswith("data_"):
                    break
                if "'" in s or "[" in s:
                    has_special = True
                i += 1
            data_lines = lines[start:i]
            if labels and data_lines and not has_special:
                # vectorized fast path: plain whitespace table -> read_csv
                # (per-line Python tokenizing was the large-table read
                # bottleneck; quotes/vectors fall back to the tokenizer)
                import io as _io
                ncols = len(data_lines[0].split())
                names = labels[:ncols]
                # rows with MORE tokens than labels (ragged legacy files):
                # absorb extras into dummy columns — and always pass
                # index_col=False, else pandas silently promotes the first
                # column to the index and shifts every field left
                extra = [f"__extra{k}" for k in range(ncols - len(names))]
                df = pd.read_csv(_io.StringIO("\n".join(data_lines)),
                                 sep=r"\s+", header=None,
                                 names=names + extra, index_col=False)
                if extra:
                    df = df.drop(columns=extra)
            elif labels and data_lines:
                rows = [_tokenize_row(l) for l in data_lines]
                df = pd.DataFrame(rows, columns=labels[: len(rows[0])])
            elif labels:
                df = pd.DataFrame({l: [] for l in labels})
            else:
                df = pd.DataFrame()
            blocks.append(StarBlock(name, df, row_format=False))
        elif i < n and lines[i].strip().startswith("_"):
            # row (key/value) format
            kv = {}
            while i < n:
                s = lines[i].strip()
                if not s.startswith("_"):
                    break
                toks = s.split(None, 1)
                key = ALIASES.get(toks[0][1:], toks[0][1:])
                val = _tokenize_row(toks[1])[0] if len(toks) > 1 else ""
                kv[key] = val
                i += 1
            blocks.append(StarBlock(name, pd.DataFrame([kv]), row_format=True))
        else:
            # empty block
            blocks.append(StarBlock(name, pd.DataFrame(), row_format=False))
    return blocks


def read_star(path: str) -> list[StarBlock]:
    with open(path, "r", errors="replace") as f:
        return parse_star(f.read())


def _fmt_value(label: str, v) -> str:
    if isinstance(v, (np.ndarray, list, tuple)):
        body = " ".join(f"{float(x):g}" for x in np.asarray(v).ravel())
        return f"[{body}]"
    t = label_type(label)
    if isinstance(v, (bool, np.bool_)):
        return f"{int(v):6d}"
    if isinstance(v, (int, np.integer)):
        return f"{int(v):6d}"
    if isinstance(v, (float, np.floating)):
        if t is LabelType.INT or t is LabelType.LONG:
            return f"{int(v):6d}"
        return f"{float(v):12.6f}"
    s = str(v)
    if s == "" or any(ch.isspace() for ch in s):
        return f"'{s}'"
    return s


def _fmt_column(label: str, series) -> np.ndarray:
    """Vectorized column formatting (matches _fmt_value element-wise).

    Per-row Python formatting was the metadata-write bottleneck at
    production scale (measured 14k rows/s on 200k-row tables); whole-column
    numpy formatting makes writes IO-bound."""
    arr = series.to_numpy()
    t = label_type(label)
    if arr.dtype == object:
        # strings / vectors / mixed: detect pure-string fast path
        if all(isinstance(v, str) for v in arr[:16]):
            try:
                s = arr.astype(str)
                need_q = np.char.equal(s, "") | \
                    (np.char.find(s, " ") >= 0) | (np.char.find(s, "\t") >= 0)
                if need_q.any():
                    quoted = np.char.add(np.char.add("'", s), "'")
                    return np.where(need_q, quoted, s)
                return s
            except (TypeError, ValueError):
                pass
        return np.array([_fmt_value(label, v) for v in arr])
    if arr.dtype.kind in "bi" or (arr.dtype.kind == "u"):
        return np.char.mod("%6d", arr.astype(np.int64))
    if arr.dtype.kind == "f":
        if t is LabelType.INT or t is LabelType.LONG:
            return np.char.mod("%6d", arr.astype(np.int64))
        return np.char.mod("%12.6f", arr)
    return np.array([_fmt_value(label, v) for v in arr])


def extract_comment(text: str) -> str:
    """File-level comment: the '# ' lines between the XMIPP_STAR_1 header
    and the first data_ block, word-rejoined (reference MetaData comment,
    test_metadata_vec_main.cpp Comment — long comments wrap at ~80 chars
    and must roundtrip)."""
    parts = []
    for line in text.splitlines()[1:]:
        s = line.strip()
        if s.startswith("#"):
            parts.append(s[1:].strip())
        elif s:
            break
    return " ".join(p for p in parts if p)


def format_star(blocks: list[StarBlock], comment: str = "") -> str:
    import textwrap
    out = io.StringIO()
    out.write(STAR_HEADER + "\n")
    if comment:
        for ln in textwrap.wrap(comment, width=78):
            out.write(f"# {ln}\n")
    else:
        out.write("# \n")
    for blk in blocks:
        out.write(f"data_{blk.name}\n")
        df = blk.df
        if blk.row_format and len(df) == 1:
            row = df.iloc[0]
            for label in df.columns:
                out.write(f" _{label} {_fmt_value(label, row[label]).strip()}\n")
        else:
            out.write("loop_\n")
            for label in df.columns:
                out.write(f" _{label}\n")
            if len(df):
                cols = [_fmt_column(l, df[l]) for l in df.columns]
                lines = cols[0]
                for c in cols[1:]:
                    lines = np.char.add(np.char.add(lines, " "), c)
                out.write(" \n".join(lines.tolist()))
                out.write(" \n")
        out.write("\n")
    return out.getvalue()


def write_star(path: str, blocks: list[StarBlock], append: bool = False,
               comment: str = "") -> None:
    if append:
        import os
        existing = read_star(path) if os.path.exists(path) else []
        # same-named blocks are replaced IN PLACE (file order preserved —
        # reference MD_APPEND semantics pinned by test_metadata_vec_main.cpp
        # WriteIntermediateBlock); new names append at the end
        by_name = {b.name: b for b in blocks}
        merged = [by_name.pop(e.name, e) for e in existing]
        blocks = merged + list(by_name.values())
    with open(path, "w") as f:
        f.write(format_star(blocks, comment=comment))
