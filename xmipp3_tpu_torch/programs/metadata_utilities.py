"""xmipp_metadata_utilities — metadata algebra CLI.

The reference package's programs/metadata_utilities.py, on the host as
there (pandas tables, numpy draws; no pixel work, so no device).

Contract: reference metadata_utilities program
(libraries/reconstruction/metadata_utilities.cpp:54-142 grammar,
:218-520 semantics — set ops on a join label, SQLite modify_values /
select expressions, fill generators, file ops, query aggregates).
"""
from __future__ import annotations

import os
import shutil

import numpy as np

from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.filename import as_filename
from xmipp3_tpu_torch.core.metadata import MetaData
from xmipp3_tpu_torch.core.program import XmippProgram


class ProgMetadataUtilities(XmippProgram):
    name = "xmipp_metadata_utilities"

    def defineParams(self):
        self.addUsageLine("Perform operations on metadata files.")
        self.addParamsLine(" -i <metadata>       : Input metadata file")
        self.addParamsLine("[-o <metadata=\"\">]   : Output metadata (default: overwrite input)")
        self.addParamsLine("[--set <set_operation> <md2_file> <label=image> <label2=image2>] : Set operations")
        self.addParamsLine("    where <set_operation>")
        self.addParamsLine("       union        : Union with md2; duplicated label values appear once")
        self.addParamsLine("       union_all    : Union with md2 keeping duplicates")
        self.addParamsLine("       intersection : Rows whose label value occurs in md2")
        self.addParamsLine("       subtraction  : Rows whose label value does not occur in md2")
        self.addParamsLine("       join         : Inner join with md2 on label")
        self.addParamsLine("       natural_join : Inner join on all common labels")
        self.addParamsLine("       inner_join   : Inner join with label=label2")
        self.addParamsLine("       merge        : Merge columns with md2 (same size, same order)")
        self.addParamsLine("    alias -s;")
        self.addParamsLine("[--operate <operation>] : Operations on the metadata structure")
        self.addParamsLine("    where <operation>")
        self.addParamsLine("       sort <label=image> <order=asc> : Sort by label (label:col for vector column; asc|desc)")
        self.addParamsLine("       percentile <labelIn> <labelOut> : Fill labelOut with the 0..1 percentile of labelIn")
        self.addParamsLine("       random_subset <size> : Random subset without replacement, sorted by image")
        self.addParamsLine("       bootstrap            : Bootstrap subset (with replacement), sorted by image")
        self.addParamsLine("       randomize            : Randomize row order")
        self.addParamsLine("       keep_column <labels> : Keep only these columns")
        self.addParamsLine("       drop_column <labels> : Remove these columns")
        self.addParamsLine("       remove_duplicates <label> : Remove rows duplicated on label")
        self.addParamsLine("       rename_column <labels> : Rename a column (old new)")
        self.addParamsLine("       modify_values <expression> : SQLite SET expression, e.g. \"angleRot=2.*angleRot\"")
        self.addParamsLine("       expand <factor>      : Replicate the table factor times")
        self.addParamsLine("    alias -e;")
        self.addParamsLine("[--file <file_operation>] : File operations")
        self.addParamsLine("    where <file_operation>")
        self.addParamsLine("       copy <directory> <label=image> : Copy files named at label into directory")
        self.addParamsLine("       move <directory> <label=image> : Move files named at label into directory")
        self.addParamsLine("       delete <label=image>           : Delete files named at label")
        self.addParamsLine("       import_txt <labels>            : Import a text file specifying its columns")
        self.addParamsLine("    alias -f;")
        self.addParamsLine("[--query <query_operation>] : Query operations")
        self.addParamsLine("    where <query_operation>")
        self.addParamsLine("       select <expression> : Keep rows satisfying a SQL/pandas expression")
        self.addParamsLine("       count <label>       : Rows per distinct label value (-> count column)")
        self.addParamsLine("       sum <label1> <label2> : Group by label1, sum label2 (-> sum column)")
        self.addParamsLine("       size                : Print metadata size")
        self.addParamsLine("       labels              : Print metadata labels")
        self.addParamsLine("       blocks              : Print blocks in file")
        self.addParamsLine("    alias -q;")
        self.addParamsLine("[--fill <labels> <fill_mode>] : Fill column values")
        self.addParamsLine("    where <fill_mode>")
        self.addParamsLine("       constant <value>            : Constant value")
        self.addParamsLine("       lineal <init_value> <step>  : Linear series")
        self.addParamsLine("       rand_uniform <a=0.> <b=1.>  : Uniform in [a, b]")
        self.addParamsLine("       rand_gaussian <mean=0.> <stddev=1.> : Gaussian")
        self.addParamsLine("       rand_student <mean=0.> <stddev=1.> <df=3.> : Student-t")
        self.addParamsLine("       expand : Expand each row with the metadata file the column names")
        self.addParamsLine("    alias -l;")
        self.addParamsLine("[--print] : Print metadata to stdout")
        self.addParamsLine("    alias -p;")
        self.addParamsLine("[--mode <mode=overwrite>] : overwrite | append (append = replace only this block)")

    # ------------------------------------------------------------------
    def run(self):
        fn_in = self.getParam("-i")
        fn_out = self.getParam("-o") if self.checkParam("-o") else fn_in
        self._write = True

        import_txt = (self.checkParam("--file")
                      and self.getListParam("--file")[0] == "import_txt")
        blocks_q = (self.checkParam("--query")
                    and self.getListParam("--query")[0] == "blocks")
        md = MetaData() if (import_txt or blocks_q) else MetaData(fn_in)

        if self.checkParam("--set"):
            md = self._do_set(md)
        if self.checkParam("--operate"):
            md = self._do_operate(md)
        if self.checkParam("--file"):
            md = self._do_file(md, fn_in)
        if self.checkParam("--query"):
            md = self._do_query(md, fn_in)
        if self.checkParam("--fill"):
            self._do_fill(md)
        if self.checkParam("--print"):
            print(md)

        if self._write:
            md.write(fn_out, append=self.checkParam("--mode") and
                     self.getParam("--mode") == "append")
        self.md_result = md

    # ------------------------------------------------------------------
    def _do_set(self, md: MetaData) -> MetaData:
        toks = self.getListParam("--set")
        op, fn2 = toks[0], toks[1]
        label = toks[2] if len(toks) > 2 else "image"
        label2 = toks[3] if len(toks) > 3 else "image2"
        md2 = MetaData(fn2)
        if op == "union":
            if md.isEmpty():
                return md2
            md.unionAll(md2)
            md._df = md._df.drop_duplicates(
                subset=label if label in md._df.columns else None
            ).reset_index(drop=True)
        elif op == "union_all":
            if md.isEmpty():
                return md2
            md.unionAll(md2)
        elif op == "intersection":
            md.intersection(md2, label)
        elif op == "subtraction":
            md.subtraction(md2, label)
        elif op == "join":
            md = MetaData().join1(md, md2, label, join_type="inner")
        elif op == "natural_join":
            md = MetaData().joinNatural(md, md2)
        elif op == "inner_join":
            md = MetaData().join2(md, md2, label, label2, join_type="inner")
        elif op == "merge":
            md.merge(md2)
        else:
            raise XmippError(ErrCode.ARG_INCORRECT, f"--set {op}")
        return md

    def _do_operate(self, md: MetaData) -> MetaData:
        toks = self.getListParam("--operate")
        op = toks[0]
        rng = np.random.default_rng(getattr(self, "seed", None))
        if op == "sort":
            label = toks[1] if len(toks) > 1 else "image"
            asc = (toks[2] if len(toks) > 2 else "asc") == "asc"
            if ":" in label:  # vector label component, e.g. NMADisplacements:0
                name, col = label.rsplit(":", 1)
                key = md._df[name].map(lambda v: np.asarray(v).ravel()[int(col)])
                order = np.argsort(key.to_numpy(), kind="stable")
                if not asc:
                    order = order[::-1]
                md._df = md._df.iloc[order].reset_index(drop=True)
            else:
                md.sort(label, ascending=asc)
        elif op == "percentile":
            md.sort(toks[1], ascending=True)
            md._df[toks[2]] = (np.arange(len(md)) + 1.0) / len(md)
        elif op == "random_subset":
            n = int(toks[1])
            idx = rng.permutation(len(md))[:n]
            md._df = md._df.iloc[idx].reset_index(drop=True)
            if "image" in md._df.columns:
                md.sort("image")
        elif op == "bootstrap":
            idx = rng.integers(0, len(md), size=len(md))
            md._df = md._df.iloc[idx].reset_index(drop=True)
            if "image" in md._df.columns:
                md.sort("image")
        elif op == "randomize":
            md.randomize(seed=0)
        elif op == "keep_column":
            cols = toks[1].replace(",", " ").split()
            md._df = md._df[cols]
        elif op == "drop_column":
            cols = toks[1].replace(",", " ").split()
            md._df = md._df.drop(
                columns=[c for c in cols if c in md._df.columns])
        elif op == "remove_duplicates":
            md._df = md._df.drop_duplicates(subset=toks[1]
                                            ).reset_index(drop=True)
        elif op == "rename_column":
            pair = toks[1].replace(",", " ").split()
            md.renameColumn(pair[0], pair[1])
        elif op == "modify_values":
            md.operate(" ".join(toks[1:]))
        elif op == "expand":
            factor = int(toks[1])
            out = MetaData()
            for _ in range(factor):
                out.unionAll(md)
            md = out
        else:
            raise XmippError(ErrCode.ARG_INCORRECT, f"--operate {op}")
        return md

    def _do_file(self, md: MetaData, fn_in: str) -> MetaData:
        toks = self.getListParam("--file")
        op = toks[0]
        if op == "import_txt":
            md.readPlain(fn_in, toks[1])
            return md
        if op == "delete":
            label = toks[1] if len(toks) > 1 else "image"
            self._write = False
            for fn in md.getColumnValues(label):
                path = as_filename(fn).path
                if os.path.exists(path):
                    os.remove(path)
            return md
        if op not in ("copy", "move"):
            raise XmippError(ErrCode.ARG_INCORRECT, f"--file {op}")
        directory = toks[1]
        label = toks[2] if len(toks) > 2 else "image"
        os.makedirs(directory, exist_ok=True)
        new_vals = []
        for fn in md.getColumnValues(label):
            f = as_filename(fn)
            base = os.path.basename(f.path)
            dst = os.path.join(directory, base)
            if not os.path.exists(dst):
                (shutil.copy2 if op == "copy" else shutil.move)(f.path, dst)
            new_vals.append(f"{f.prefix}@{base}" if f.prefix else base)
        md.setColumnValues(label, new_vals)
        return md

    def _do_query(self, md: MetaData, fn_in: str) -> MetaData:
        toks = self.getListParam("--query")
        op = toks[0]
        if op == "select":
            out = MetaData()
            out.importObjects(md, " ".join(toks[1:]))
            return out
        if op == "count":
            return MetaData().aggregateOn(md, "count", toks[1], toks[1],
                                          "count")
        if op == "sum":
            return MetaData().aggregateOn(md, "sum", toks[1], toks[2], "sum")
        if op == "size":
            self._write = False
            print(f"{fn_in} size is: {md.size()}")
        elif op == "labels":
            self._write = False
            print(f"{fn_in} has labels:")
            for lab in md.getActiveLabels():
                print(f"  {lab}")
        elif op == "blocks":
            self._write = False
            print(f"Blocks in {fn_in}:")
            for b in MetaData.blocksInFile(as_filename(fn_in).path):
                print(b)
        else:
            raise XmippError(ErrCode.ARG_INCORRECT, f"--query {op}")
        return md

    def _do_fill(self, md: MetaData) -> None:
        toks = self.getListParam("--fill")
        labels = toks[0].replace(",", " ").split()
        if not labels:
            raise XmippError(ErrCode.PARAM_INCORRECT,
                             "You should provide at least one label to fill")
        mode = toks[1]
        rng = np.random.default_rng(getattr(self, "seed", None))
        for label in labels:
            if mode == "expand":
                md.fillExpand(label)
            elif mode == "constant":
                md.fillConstant(label, _parse(toks[2]))
            elif mode == "lineal":
                md.fillLinear(label, float(toks[2]), float(toks[3]))
            elif mode == "rand_uniform":
                a = float(toks[2]) if len(toks) > 2 else 0.0
                b = float(toks[3]) if len(toks) > 3 else 1.0
                md.setColumnValues(label, rng.uniform(a, b, len(md)))
            elif mode == "rand_gaussian":
                m = float(toks[2]) if len(toks) > 2 else 0.0
                s = float(toks[3]) if len(toks) > 3 else 1.0
                md.setColumnValues(label, rng.normal(m, s, len(md)))
            elif mode == "rand_student":
                m = float(toks[2]) if len(toks) > 2 else 0.0
                s = float(toks[3]) if len(toks) > 3 else 1.0
                df = float(toks[4]) if len(toks) > 4 else 3.0
                md.setColumnValues(label, m + s * rng.standard_t(df, len(md)))
            else:
                raise XmippError(ErrCode.ARG_INCORRECT, f"--fill {mode}")


def _parse(tok: str):
    try:
        return int(tok)
    except ValueError:
        try:
            return float(tok)
        except ValueError:
            return tok


PROGRAM = ProgMetadataUtilities
