"""MetaData — STAR-table metadata engine (pandas-backed).

Equivalent of xmippCore's MetaDataVec (in-memory table keyed by MDL labels;
behavioral contract in SURVEY.md §1.1: block addressing "block@file.xmd",
unionAll/sort for MPI-style gathers, per-row get/set, firstObject).
The reference keeps a second SQLite-backed impl (MetaDataDb) for huge tables;
here one pandas impl covers both roles (vectorized columns feed device batches
directly, which is the TPU-native reason to be columnar).
"""
from __future__ import annotations

import os
from typing import Any, Iterable, Iterator

import numpy as np
import pandas as pd

from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.filename import as_filename
from xmipp3_tpu_torch.core.star import (StarBlock, _parse_value, extract_comment,
                                  format_star, read_star, write_star)


class Row(dict):
    """One metadata object (label -> value)."""

    def getValue(self, label: str, default=None):
        return self.get(label, default)

    def setValue(self, label: str, value) -> None:
        self[label] = value


class MetaData:
    def __init__(self, source=None, block: str | None = None):
        self._df = pd.DataFrame()
        self.row_format = False
        self.comment = ""
        self._block_read = "noname"
        if source is not None:
            if isinstance(source, pd.DataFrame):
                self._df = source.reset_index(drop=True)
            elif isinstance(source, MetaData):
                self._df = source._df.copy()
                self.row_format = source.row_format
            elif isinstance(source, (list, tuple)) and source and isinstance(source[0], dict):
                self._df = pd.DataFrame(list(source))
            else:
                self.read(source, block=block)

    # ---------------- properties ----------------
    @property
    def df(self) -> pd.DataFrame:
        return self._df

    def size(self) -> int:
        return len(self._df)

    def __len__(self) -> int:
        return len(self._df)

    def isEmpty(self) -> bool:
        return len(self._df) == 0

    def getActiveLabels(self) -> list[str]:
        return list(self._df.columns)

    def containsLabel(self, label: str) -> bool:
        return label in self._df.columns

    def setComment(self, comment: str) -> None:
        """File-level comment, persisted on write (reference setComment,
        test_metadata_vec_main.cpp Comment)."""
        self.comment = comment

    def getComment(self) -> str:
        return self.comment

    def setPrecission(self, digits: int) -> None:
        """Decimal digits used by == on float values (reference
        setPrecission, test_metadata_vec_main.cpp SimilarToOperator:
        |a-b| < 10^-digits counts as equal)."""
        self._precission = digits

    def __eq__(self, other) -> bool:
        """Value equality, column-order insensitive, floats compared to
        the configured precission (reference MetaData::operator==)."""
        if not isinstance(other, MetaData):
            return NotImplemented
        if len(self) != len(other) or \
                set(self._df.columns) != set(other._df.columns):
            return False
        tol = 10.0 ** -getattr(self, "_precission", 4)
        for c in self._df.columns:
            a, b = self._df[c], other._df[c]
            if (pd.api.types.is_numeric_dtype(a.dtype)
                    and pd.api.types.is_numeric_dtype(b.dtype)):
                if not np.all(np.abs(a.to_numpy(dtype=float)
                                     - b.to_numpy(dtype=float)) < tol):
                    return False
            elif not all(_cell_eq(x, y) for x, y in zip(a, b)):
                return False
        return True

    __hash__ = None  # value-compared containers; identity hashing would lie

    # ---------------- I/O ----------------
    def read(self, fn, block: str | None = None) -> "MetaData":
        fn = as_filename(fn)
        block = block or fn.block
        path = fn.path
        if not os.path.exists(path):
            raise XmippError(ErrCode.IO_NOTEXIST, path)
        if path.endswith(".sqlite"):
            self._df = _read_sqlite(path, block)
            return self._finish_read()
        blocks = read_star(path)
        try:
            with open(path) as _fh:
                self.comment = extract_comment(_fh.read(2048))
        except OSError:
            pass
        if not blocks:
            legacy = _read_legacy_selsdoc(path)
            if legacy is not None:
                self._df = legacy
                return self._finish_read()
            self._df = pd.DataFrame()
            return self._finish_read()
        if block is None:
            chosen = blocks[0]
        else:
            named = [b for b in blocks if b.name == block]
            if not named:
                # block names act as regular expressions: all matching
                # blocks concatenate in file order (reference
                # MetaData::read, test_metadata_vec_main.cpp
                # CheckRegularExpression)
                import re as _re
                try:
                    pat = _re.compile(block)
                except _re.error:
                    pat = None
                if pat is not None:
                    named = [b for b in blocks if pat.fullmatch(b.name)]
            if not named:
                raise XmippError(ErrCode.MD_BADBLOCK, f"{block}@{path}")
            if len(named) > 1:
                self._df = pd.concat([b.df for b in named],
                                     ignore_index=True)
                self.row_format = named[0].row_format
                self._block_read = named[0].name
                return self._finish_read()
            chosen = named[0]
        self._df = chosen.df.reset_index(drop=True)
        self.row_format = chosen.row_format
        self._block_read = chosen.name
        return self._finish_read()

    def _finish_read(self) -> "MetaData":
        """Record the full parsed size and honor setMaxRows truncation
        (reference setMaxRows/getParsedLines, test_metadata_vec_main.cpp
        MDInfo: a 1-row capped read still reports the file's row count)."""
        self._parsed_lines = len(self._df)
        cap = getattr(self, "_max_rows", None)
        if cap is not None and len(self._df) > cap:
            self._df = self._df.iloc[:cap].reset_index(drop=True)
        return self

    def setMaxRows(self, n: int) -> None:
        self._max_rows = n

    def getParsedLines(self) -> int:
        return getattr(self, "_parsed_lines", len(self._df))

    def write(self, fn, block: str | None = None, append: bool = False) -> None:
        fn = as_filename(fn)
        block = block or fn.block or "noname"
        if fn.path.endswith(".sqlite"):
            _write_sqlite(fn.path, block, self._df, append=append)
            return
        write_star(fn.path, [StarBlock(block, self._df, self.row_format)],
                   append=append or fn.block is not None and os.path.exists(fn.path),
                   comment=self.comment)

    def __str__(self) -> str:
        return format_star([StarBlock("noname", self._df, self.row_format)])

    @staticmethod
    def blocksInFile(path: str) -> list[str]:
        p = as_filename(path).path
        if p.endswith(".sqlite"):
            return _sqlite_blocks(p)
        return [b.name for b in read_star(p)]

    # ---------------- object access ----------------
    def addObject(self) -> int:
        idx = len(self._df)
        self._df = self._df.reindex(range(idx + 1))
        return idx

    def addRow(self, row: dict) -> int:
        idx = len(self._df)
        new = pd.DataFrame(index=[idx])
        for k, v in row.items():
            if isinstance(v, (np.ndarray, list, tuple)):
                new[k] = pd.Series([np.asarray(v)], index=[idx], dtype=object)
            else:
                new[k] = [_store(v)]
        self._df = pd.concat([self._df, new]) if len(self._df) else new
        return idx

    @staticmethod
    def fromRows(rows: Iterable[dict]) -> "MetaData":
        """Bulk constructor (preferred over addRow in loops)."""
        return MetaData(pd.DataFrame(list(rows)))

    def setValue(self, label: str, value, objId: int) -> None:
        self._df.loc[objId, label] = _store(value)

    def getValue(self, label: str, objId: int):
        if label not in self._df.columns:
            return None
        v = self._df.loc[objId, label]
        return v.item() if isinstance(v, np.generic) else v

    def getColumnValues(self, label: str) -> list:
        if label not in self._df.columns:
            raise XmippError(ErrCode.MD_MISSINGLABEL, label)
        return list(self._df[label])

    def setColumnValues(self, label: str, values: Iterable) -> None:
        vals = list(values)
        if len(self._df) == 0 and vals:
            self._df = pd.DataFrame(index=range(len(vals)))
        self._df[label] = vals

    def getColumn(self, label: str, default=None) -> np.ndarray:
        """Vectorized column fetch (the device-batch feeder)."""
        if label not in self._df.columns:
            if default is None:
                raise XmippError(ErrCode.MD_MISSINGLABEL, label)
            return np.full(len(self._df), default)
        return self._df[label].to_numpy()

    def firstObject(self) -> int:
        if self.isEmpty():
            raise XmippError(ErrCode.MD_NOACTIVE, "empty metadata")
        return int(self._df.index[0])

    def getRow(self, objId: int) -> Row:
        r = Row(self._df.loc[objId].dropna().to_dict())
        return Row({k: (v.item() if isinstance(v, np.generic) else v)
                    for k, v in r.items()})

    def __iter__(self) -> Iterator[int]:
        return iter(self._df.index)

    def iterRows(self) -> Iterator[Row]:
        for i in self._df.index:
            yield self.getRow(i)

    # ---------------- algebra ----------------
    def unionAll(self, other: "MetaData") -> None:
        self._df = pd.concat([self._df, other._df], ignore_index=True)

    def sort(self, label: str = "itemId", ascending: bool = True,
             limit: int | None = None, offset: int = 0) -> None:
        """Stable sort; optional (limit, offset) window of the sorted rows
        (reference MetaDataVec::sort(md, label, asc, limit, offset),
        test_metadata_vec_main.cpp Sort)."""
        df = self._df.sort_values(label, ascending=ascending,
                                  kind="stable").reset_index(drop=True)
        if offset or limit is not None:
            stop = None if limit is None else offset + limit
            df = df.iloc[offset:stop].reset_index(drop=True)
        self._df = df

    def split(self, n: int, sort_label: str | None = None
              ) -> list["MetaData"]:
        """Split into n parts (sorted first when sort_label is given); the
        source is left untouched (reference MetaDataVec::split)."""
        df = self._df if sort_label is None else \
            self._df.sort_values(sort_label, kind="stable")
        df = df.reset_index(drop=True)
        bounds = np.linspace(0, len(df), n + 1).round().astype(int)
        return [MetaData(df.iloc[a:b].reset_index(drop=True))
                for a, b in zip(bounds[:-1], bounds[1:])]

    def selectPart(self, other: "MetaData", start: int, num: int,
                   sort_label: str | None = None) -> None:
        """Fill self with rows [start, start+num) of other, optionally
        sorted (reference MetaDataVec::selectPart; 'objId' keeps the
        original order)."""
        df = other._df
        if sort_label not in (None, "objId"):
            df = df.sort_values(sort_label, kind="stable")
        self._df = df.iloc[start:start + num].reset_index(drop=True)

    def removeDuplicates(self, other: "MetaData | None" = None) -> None:
        """Fill self with other (or self) minus exact duplicate rows,
        keeping first occurrences (reference removeDuplicates)."""
        src = self._df if other is None else other._df
        self._df = src.drop_duplicates().reset_index(drop=True)

    def randomize(self, other: "MetaData | None" = None,
                  seed: int | None = None) -> None:
        """Fill self with a random permutation of other's rows (or self's)."""
        src = self._df if other is None else other._df
        self._df = src.sample(frac=1, random_state=seed
                              ).reset_index(drop=True)

    def importObjects(self, other: "MetaData", expr: str = "") -> None:
        """Fill self with other's rows matching a query expression
        (reference importObjects + MDValueEQ/MDMultiQuery/MDExpression).
        Accepts pandas syntax ('x == 3 and y == 4') or, as the reference
        does, a SQL WHERE clause ('angleRot > 10 AND anglePsi < 0.5')."""
        if not expr:
            self._df = other._df.reset_index(drop=True)
            return
        try:
            df = other._df.query(expr)
        except Exception:
            con = _sqlite_mem(other._df)
            try:
                df = _sqlite_fetch(con,
                                   f"SELECT * FROM objects WHERE {expr}",
                                   like=other._df)
            finally:
                con.close()
        self._df = df.reset_index(drop=True)

    def removeObjects(self, mask) -> None:
        self._df = self._df[~np.asarray(mask)].reset_index(drop=True)

    def removeDisabled(self) -> None:
        if "enabled" in self._df.columns:
            self._df = self._df[self._df["enabled"] != -1].reset_index(drop=True)

    def select(self, expr: str) -> "MetaData":
        return MetaData(self._df.query(expr))

    def fillConstant(self, label: str, value) -> None:
        self._df[label] = [value] * len(self._df)

    def fillLinear(self, label: str, start: float, step: float) -> None:
        self._df[label] = start + step * np.arange(len(self._df))

    def renameColumn(self, old: str, new: str) -> None:
        self._df = self._df.rename(columns={old: new})

    def copyColumn(self, to_label: str, from_label: str) -> None:
        """Duplicate a column under a new label (reference copyColumn,
        test_metadata_vec_main.cpp CopyColumn)."""
        self._df[to_label] = self._df[from_label]

    def setRow(self, row: dict, objId: int) -> None:
        """Overwrite one object's values from a row mapping (reference
        setRow, test_metadata_vec_main.cpp updateRow)."""
        for label, value in row.items():
            self.setValue(label, value, objId)

    def removeLabel(self, label: str) -> None:
        if label in self._df.columns:
            self._df = self._df.drop(columns=[label])

    def readPlain(self, path: str, labels: str) -> None:
        """Import a whitespace/comma text file, assigning columns to the
        given space-separated label list (reference MetaData::readPlain,
        used by `metadata_utilities --file import_txt`)."""
        names = labels.replace(",", " ").split()
        rows = []
        with open(as_filename(path).path) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith(("#", ";")):
                    continue
                toks = line.split()
                rows.append({n: _parse_value(t)
                             for n, t in zip(names, toks)})
        self._df = pd.DataFrame(rows, columns=names)

    def copy(self) -> "MetaData":
        out = MetaData(self._df.copy())
        out.row_format = self.row_format
        return out

    def aggregate(self, op: str, label: str):
        return getattr(self._df[label], op)()

    # ---------------- relational ops (reference MetaDataDb SQL layer,
    # test_metadata_db_main.cpp pins all semantics) ----------------
    def join1(self, md_left: "MetaData", md_other: "MetaData", labels,
              join_type: str = "left") -> "MetaData":
        """Join on shared label(s); the right side contributes only its
        NEW columns — on a column collision the left side wins
        (MetaDataDb::join1, pinned by LeftJoin/JoinVector gtests: a left
        row matching k right rows appears k times)."""
        if isinstance(labels, str):
            labels = [labels]
        right_new = [c for c in md_other._df.columns
                     if c in labels or c not in md_left._df.columns]
        merged = md_left._df.merge(md_other._df[right_new], on=list(labels),
                                   how="left" if join_type == "left"
                                   else "inner")
        self._df = merged.reset_index(drop=True)
        return self

    def join2(self, md_left: "MetaData", md_right: "MetaData",
              label_left: str, label_right: str,
              join_type: str = "inner") -> "MetaData":
        """Join left.label_left == right.label_right; the right join
        column is dropped and colliding right columns lose to the left
        (MetaDataDb::join2, InnerJoin1/InnerJoin2 gtests)."""
        keep = [c for c in md_right._df.columns
                if c == label_right or c not in md_left._df.columns]
        merged = md_left._df.merge(
            md_right._df[keep], left_on=label_left, right_on=label_right,
            how="left" if join_type == "left" else "inner")
        if label_right != label_left and label_right in merged.columns:
            merged = merged.drop(columns=[label_right])
        self._df = merged.reset_index(drop=True)
        return self

    def joinNatural(self, md1: "MetaData", md2: "MetaData") -> "MetaData":
        """Inner join on ALL shared labels (MetaDataDb::joinNatural)."""
        common = [c for c in md1._df.columns if c in md2._df.columns]
        return self.join1(md1, md2, common, join_type="inner")

    def intersection(self, other: "MetaData", label: str) -> None:
        """Keep rows whose `label` value occurs in `other`
        (MetaDataDb::intersection, Intersect gtest)."""
        keep = self._df[label].isin(set(other._df[label]))
        self._df = self._df[keep].reset_index(drop=True)

    def subtraction(self, other: "MetaData", label: str) -> None:
        """Remove rows whose `label` value occurs in `other`
        (MetaDataDb::subtraction, Substraction gtest)."""
        keep = ~self._df[label].isin(set(other._df[label]))
        self._df = self._df[keep].reset_index(drop=True)

    def merge(self, other: "MetaData") -> None:
        """Column-wise merge: other's columns are zipped onto this table
        row by row (MetaDataDb::merge, Merge gtest)."""
        right = other._df.reset_index(drop=True)
        left = self._df.reset_index(drop=True)
        for c in right.columns:
            if c not in left.columns:
                left[c] = right[c]
        self._df = left

    def operate(self, expr: str) -> None:
        """SQL UPDATE SET clause run over the whole table — true SQLite
        semantics including string functions, `||` concatenation, and an
        optional trailing WHERE (MetaDataDb::operate issues
        `UPDATE objects SET <expr>`; math extensions per
        MDSql::activateMathExtensions; Operate/OperateExt gtests)."""
        con = _sqlite_mem(self._df)
        try:
            con.execute(f"UPDATE objects SET {expr}")
            self._df = _sqlite_fetch(con, "SELECT * FROM objects",
                                     like=self._df)
        finally:
            con.close()

    def distinct(self, other: "MetaData", label: str) -> "MetaData":
        """Fill self with the unique values of other's `label`, first-seen
        order (MetaDataDb::distinct, Distinct gtest)."""
        vals = other._df[label].drop_duplicates().reset_index(drop=True)
        self._df = pd.DataFrame({label: vals})
        return self

    def fillExpand(self, label: str) -> None:
        """Each row's `label` names a metadata file; expand the row with
        that file's (row-format) columns (MetaData::fillExpand,
        FillExpand gtest — the CTF_MODEL pattern)."""
        cache: dict[str, dict] = {}
        extra_rows = []
        for fn in self._df[label]:
            if fn not in cache:
                sub = MetaData(str(fn))
                cache[fn] = sub.getRow(sub.firstObject()) if len(sub) else {}
            extra_rows.append(cache[fn])
        extra = pd.DataFrame(extra_rows).reset_index(drop=True)
        base = self._df.reset_index(drop=True)
        for c in extra.columns:
            if c not in base.columns:
                base[c] = extra[c]
        self._df = base

    def aggregateOn(self, other: "MetaData", op: str, aggregate_label: str,
                    operate_label: str, result_label: str) -> "MetaData":
        """Group other by `aggregate_label` and aggregate `operate_label`
        into `result_label` (MetaDataDb::aggregate, Aggregate1 gtest)."""
        g = other._df.groupby(aggregate_label, sort=True)[operate_label]
        res = g.count() if op == "count" else getattr(g, op)()
        self._df = pd.DataFrame({aggregate_label: res.index,
                                 result_label: res.to_numpy()})
        return self

    def aggregateMulti(self, other: "MetaData", ops, operate_labels,
                       result_labels) -> "MetaData":
        """Multi-aggregate grouped by result_labels[0]
        (MetaDataDb::aggregate vector form, Aggregate2 gtest: ops[i]
        applies to operate_labels[i] -> result_labels[i+1])."""
        key = result_labels[0]
        g = other._df.groupby(key, sort=True)
        out = {key: list(g.groups.keys())}
        for op, src, dst in zip(ops, operate_labels, result_labels[1:]):
            col = g[src]
            out[dst] = (col.count() if op == "count"
                        else getattr(col, op)()).to_numpy()
        self._df = pd.DataFrame(out)
        return self

    def aggregateGroupBy(self, other: "MetaData", op: str, group_labels,
                         operate_label: str,
                         result_label: str) -> "MetaData":
        """Aggregate grouped by several labels
        (MetaDataDb::aggregateGroupBy, AggregateGroupBy gtest)."""
        g = other._df.groupby(list(group_labels), sort=True)[operate_label]
        res = (g.count() if op == "count" else getattr(g, op)()).reset_index()
        res = res.rename(columns={operate_label: result_label})
        self._df = res
        return self

    def addIndex(self, label: str) -> None:
        """SQL index creation hint — a no-op on the columnar backend
        (MetaDataDb::addIndex, AddIndex gtest)."""

    @staticmethod
    def existsBlock(fn) -> bool:
        """True if 'block@file' names an existing block
        (MetaDataDb::existsBlock, ExistsBlock gtest)."""
        f = as_filename(fn)
        if not os.path.exists(f.path):
            return False
        if f.block is None:
            return True
        return f.block in MetaData.blocksInFile(f.path)


def _cell_eq(x, y) -> bool:
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        return np.array_equal(np.asarray(x), np.asarray(y))
    if x != x and y != y:  # both NaN
        return True
    return x == y


def _store(v):
    if isinstance(v, np.generic):
        return v.item()
    return v


# ---------------------------------------------------------------------------
# SQLite metadata backend (reference MetaDataDb native format; block ==
# table, write without MD_APPEND recreates the file, append replaces only
# the named table — multiWriteSqlite gtest)
# ---------------------------------------------------------------------------

def _sqlite_connect(path: str):
    import sqlite3
    return sqlite3.connect(path)


def _register_extensions(con) -> None:
    """Math + string UDFs matching the reference's
    MDSql::activateMathExtensions/activateRegExtensions (sqliteExt.cpp:
    acos..floor, pi, and the string helpers usable from modify_values)."""
    import math
    import re as _re
    for name in ("acos", "asin", "atan", "acosh", "asinh", "atanh",
                 "cos", "sin", "tan", "cosh", "sinh", "tanh",
                 "degrees", "radians", "exp", "log10", "sqrt",
                 "floor", "ceil"):
        con.create_function(name, 1, getattr(math, name))
    con.create_function("log", 1, math.log)
    con.create_function("cot", 1, lambda x: math.cos(x) / math.sin(x))
    con.create_function("coth", 1, lambda x: math.cosh(x) / math.sinh(x))
    con.create_function("square", 1, lambda x: x * x)
    con.create_function("sign", 1, lambda x: (x > 0) - (x < 0))
    con.create_function("power", 2, lambda x, y: x ** y)
    con.create_function("atan2", 2, math.atan2)
    con.create_function("atn2", 2, math.atan2)
    con.create_function("pi", 0, lambda: math.pi)
    con.create_function("reverse", 1, lambda s: s[::-1])
    con.create_function("replicate", 2, lambda s, n: s * int(n))
    con.create_function("leftstr", 2, lambda s, n: s[:int(n)])
    con.create_function("rightstr", 2, lambda s, n: s[-int(n):] if n else "")
    con.create_function("charindex", 2, lambda sub, s: s.find(sub) + 1)
    con.create_function("proper", 1, lambda s: s.title())
    con.create_function("padl", 2, lambda s, n: s.rjust(int(n)))
    con.create_function("padr", 2, lambda s, n: s.ljust(int(n)))
    con.create_function("padc", 2, lambda s, n: s.center(int(n)))
    con.create_function("regexp", 2,
                        lambda pat, s: _re.search(pat, s) is not None)


def _sqlite_mem(df: pd.DataFrame):
    """In-memory sqlite table named `objects` holding df, with the
    reference math/string extensions registered — the evaluation engine
    behind operate() / SQL importObjects (MDSql's ephemeral db)."""
    con = _sqlite_connect(":memory:")
    _register_extensions(con)
    cols = ", ".join(f'"{c}"' for c in df.columns) or '"_empty"'
    con.execute(f"CREATE TABLE objects ({cols})")
    if len(df):
        ph = ", ".join("?" * len(df.columns))
        con.executemany(f"INSERT INTO objects VALUES ({ph})",
                        [tuple(_store(v) for v in row)
                         for row in df.itertuples(index=False)])
    return con


def _sqlite_fetch(con, sql: str, like: pd.DataFrame) -> pd.DataFrame:
    """Run a SELECT and rebuild a DataFrame, keeping `like`'s integer
    columns integral when SQL arithmetic preserved them."""
    cur = con.execute(sql)
    cols = [d[0] for d in cur.description]
    out = pd.DataFrame(cur.fetchall(), columns=cols)
    for c in cols:
        if (c in like.columns and len(out)
                and pd.api.types.is_integer_dtype(like[c].dtype)
                and pd.api.types.is_float_dtype(out[c].dtype)):
            vals = out[c].to_numpy()
            if np.all(vals == np.round(vals)):
                out[c] = out[c].astype(like[c].dtype)
    return out


def _sqlite_blocks(path: str) -> list[str]:
    with _sqlite_connect(path) as con:
        rows = con.execute(
            "SELECT name FROM sqlite_master WHERE type='table' "
            "ORDER BY rowid").fetchall()
    return [r[0] for r in rows]


def _read_sqlite(path: str, block: str | None) -> pd.DataFrame:
    blocks = _sqlite_blocks(path)
    if not blocks:
        return pd.DataFrame()
    name = block or blocks[0]
    if name not in blocks:
        raise XmippError(ErrCode.MD_BADBLOCK, f"{name}@{path}")
    with _sqlite_connect(path) as con:
        cur = con.execute(f'SELECT * FROM "{name}"')
        cols = [d[0] for d in cur.description]
        data = cur.fetchall()
    return pd.DataFrame(data, columns=cols)


def _write_sqlite(path: str, block: str, df: pd.DataFrame,
                  append: bool) -> None:
    if not append and os.path.exists(path):
        os.remove(path)
    with _sqlite_connect(path) as con:
        con.execute(f'DROP TABLE IF EXISTS "{block}"')
        cols = ", ".join(f'"{c}"' for c in df.columns) or '"_empty"'
        con.execute(f'CREATE TABLE "{block}" ({cols})')
        if len(df):
            ph = ", ".join("?" * len(df.columns))
            con.executemany(
                f'INSERT INTO "{block}" VALUES ({ph})',
                [tuple(_store(v) for v in row)
                 for row in df.itertuples(index=False)])
        con.commit()


def compare_two_metadata_files(fn1: str, fn2: str, rtol=1e-5, atol=1e-4) -> bool:
    """Semantic comparison of two STAR files (reference: compareTwoMetadataFiles,
    bindings/python/xmippmodule.cpp:1392-1502 area + tests/test.py:174-200)."""
    b1, b2 = read_star(as_filename(fn1).path), read_star(as_filename(fn2).path)
    if [b.name for b in b1] != [b.name for b in b2]:
        return False
    for x, y in zip(b1, b2):
        if set(x.df.columns) != set(y.df.columns) or len(x.df) != len(y.df):
            return False
        for col in x.df.columns:
            a, b = x.df[col].to_numpy(), y.df[col].to_numpy()
            if a.dtype.kind in "fiu" and b.dtype.kind in "fiu":
                if not np.allclose(a.astype(float), b.astype(float),
                                   rtol=rtol, atol=atol):
                    return False
            else:
                if not all(str(u) == str(v) for u, v in zip(a, b)):
                    return False
    return True


def _read_legacy_selsdoc(path: str):
    """Legacy Spider-era text formats (reference interface/selfile.cpp,
    docfile.cpp): .sel = "<image> <flag>" lines; .doc = header comment line
    then " <key> <n> <v1> <v2> ..." numeric rows. Returns a DataFrame or
    None if the file doesn't look like either."""
    import os
    ext = os.path.splitext(path)[1].lower()
    rows = []
    try:
        with open(path, errors="replace") as f:
            lines = [l.rstrip() for l in f if l.strip()]
    except OSError:
        return None
    if not lines:
        return None
    if ext == ".sel" or all(len(l.split()) == 2 and not l.startswith(";")
                            for l in lines[:5]):
        for l in lines:
            if l.startswith(";") or l.startswith("#"):
                continue
            toks = l.split()
            if len(toks) < 2:
                return None
            try:
                flag = int(float(toks[1]))
            except ValueError:
                return None
            rows.append({"image": toks[0], "enabled": flag})
        return pd.DataFrame(rows) if rows else None
    if ext == ".doc" or lines[0].startswith(";"):
        # DocFile: "; headerline" then "key count v1 v2 ..." (angles etc.)
        labels = ["anglePsi", "angleRot", "angleTilt", "shiftX", "shiftY",
                  "shiftZ"]
        for l in lines:
            if l.startswith(";"):
                continue
            toks = l.split()
            if len(toks) < 3:
                return None
            try:
                key = int(toks[0])
                vals = [float(t) for t in toks[2:]]
            except ValueError:
                return None
            row = {"itemId": key}
            for lab, v in zip(labels, vals):
                row[lab] = v
            rows.append(row)
        return pd.DataFrame(rows) if rows else None
    return None
