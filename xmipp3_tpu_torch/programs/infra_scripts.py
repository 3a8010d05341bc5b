"""The infra script programs of the reference package's
programs/infra_scripts.py: sync_data, compile and
test_script_importing_module (applications/scripts/{sync_data, compile,
test_script_importing_module} of the reference).

- sync_data transliterates batch_sync_data.py:38-230 (MANIFEST + md5
  download/update, DLmodels untar). urlopen drives it, so file:// mirror
  URLs work without a network and http(s) works where there is one; the
  same CLI: `xmipp_sync_data download <dest> <url> <dataset>`.
- compile mirrors batch_compile.py (ScriptCompile): it builds a user C++
  file against the port's own native library (xmipp3_tpu_torch/native,
  built on first use into its git-ignored build/) instead of the
  reference's xmipp.conf flags.
- test_script_importing_module mirrors
  batch_test_script_importing_module.py: it shows that user scripts can
  import xmippPyModules (example_module and
  example_module2.example_inmodule2, which import nothing of either
  package).

All three run on the host; none touches the card.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import tarfile
import time
from os.path import join
from urllib.request import urlopen

from xmipp3_tpu_torch.core.errors import ErrCode, XmippError
from xmipp3_tpu_torch.core.program import XmippProgram


def _md5sum(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _read_manifest(url: str, is_dlmodel: bool) -> dict[str, str]:
    """{fname: md5} from a remote MANIFEST (batch_sync_data.readManifest);
    DLmodels manifests are `md5 fname` order, datasets are `fname md5`."""
    lines = urlopen(url).readlines()
    entries = dict(x.decode("utf8").strip().split() for x in lines if
                   x.strip())
    if is_dlmodel:
        entries = {v: k for k, v in entries.items()}
    return entries


def _create_manifest(path: str) -> None:
    with open(join(path, "MANIFEST"), "w") as manifest:
        for root, _dirs, files in os.walk(path):
            for filename in set(files) - {"MANIFEST"}:
                fn = join(root, filename)
                manifest.write(
                    f"{os.path.relpath(fn, path)} {_md5sum(fn)}\n")


class ProgSyncData(XmippProgram):
    """Test-data / DLmodels fetcher (batch_sync_data.py). Positional CLI
    like the reference: `xmipp_sync_data <download|update> <destination>
    <url> <dataset>`. Without a network, point <url> at a
    local mirror with file:///path."""

    name = "xmipp_sync_data"

    def defineParams(self):
        self.addUsageLine(
            "Download/update test datasets or DLmodels from a MANIFEST'd "
            "mirror (http(s):// or file://).")
        self.addExampleLine(
            "xmipp_sync_data download /tmp/data "
            "file:///mirrors/xmipp_data testXmipp")

    def read(self, argv):
        # reference-style positional argv (batch_sync_data.py:254-263)
        if argv and not argv[0].startswith("-"):
            argv = argv[1:]
        if not argv or argv[0] in ("-h", "--help"):
            print(self.usage())
            self._help_requested = True
            return
        self._help_requested = False
        self.mode = argv[0]
        self.args = argv[1:]

    def run(self):
        if self.mode == "download":
            self._download(*self.args)
        elif self.mode == "update":
            self._update(*self.args)
        else:
            raise ValueError(
                f"unknown mode {self.mode!r} (download|update; the "
                "reference's 'upload' is a CNB-internal rsync)")

    def _download(self, destination, url, dataset):
        is_dlmodel = dataset == "DLmodels"
        if not is_dlmodel:
            known = [x.decode("utf8").strip("./\n")
                     for x in urlopen(f"{url}/MANIFEST")]
            if dataset not in known:
                print(f"Unknown dataset/model: {dataset}")
                return
            remote_manifest = f"{url}/{dataset}/MANIFEST"
            in_folder = f"/{dataset}"
        else:
            remote_manifest = f"{url}/xmipp_models_MANIFEST"
            in_folder = ""
        os.makedirs(destination, exist_ok=True)
        with open(join(destination, "MANIFEST"), "wb") as f:
            f.writelines(urlopen(remote_manifest))
        md5s = _read_manifest(remote_manifest, is_dlmodel)
        for fname, md5_remote in md5s.items():
            fpath = join(destination, fname)
            os.makedirs(os.path.dirname(fpath) or ".", exist_ok=True)
            with open(fpath, "wb") as f:
                f.writelines(urlopen(f"{url}{in_folder}/{fname}"))
            md5 = _md5sum(fpath)
            if md5 != md5_remote:
                raise XmippError(
                    ErrCode.IO_SIZE, f"Bad md5 for {fname}. Expected: "
                    f"{md5_remote} Computed: {md5}")
        print(f"...done. Downloaded files: {len(md5s)}")
        if is_dlmodel:
            self._untar_models(destination)

    def _update(self, destination, url, dataset):
        is_dlmodel = dataset == "DLmodels"
        prefix = "xmipp_models_" if is_dlmodel else ""
        in_folder = "" if is_dlmodel else f"/{dataset}"
        remote_manifest = (f"{url}/{prefix}MANIFEST" if is_dlmodel
                           else f"{url}/{dataset}/MANIFEST")
        md5s_remote = _read_manifest(remote_manifest, is_dlmodel)
        os.makedirs(destination, exist_ok=True)
        # trust the local MANIFEST only if it is newer than every tracked
        # file and <7 days old (batch_sync_data.py:119-133); else rebuild
        try:
            last = max(os.stat(join(destination, x)).st_mtime
                       for x in md5s_remote)
            t_manifest = os.stat(join(destination, "MANIFEST")).st_mtime
            assert t_manifest > last and \
                time.time() - t_manifest < 60 * 60 * 24 * 7
        except (OSError, AssertionError, ValueError):
            _create_manifest(destination)
        md5s_local = dict(
            x.strip().split() for x in open(join(destination, "MANIFEST"))
            if x.strip())
        if is_dlmodel:
            md5s_local = {v: k for k, v in md5s_local.items()}
        updated = []
        for fname, md5_remote in md5s_remote.items():
            fpath = join(destination, fname)
            if os.path.exists(fpath) and \
                    md5s_local.get(fname) == md5_remote:
                continue
            os.makedirs(os.path.dirname(fpath) or ".", exist_ok=True)
            with open(fpath, "wb") as f:
                f.writelines(urlopen(f"{url}{in_folder}/{fname}"))
            updated.append(fname)
        print(f"...done. Updated files: {len(updated)}")
        if updated:
            with open(join(destination, "MANIFEST"), "wb") as f:
                f.writelines(urlopen(remote_manifest))
        if is_dlmodel:
            self._untar_models(destination)

    @staticmethod
    def _untar_models(dirname):
        for fn in sorted(os.listdir(dirname)):
            if fn.startswith("xmipp_model_") and fn.endswith(".tgz"):
                with tarfile.open(join(dirname, fn), "r:gz") as tf:
                    tf.extractall(dirname, filter="data")


class ProgCompile(XmippProgram):
    """Compile a user C++ program against the port's native library
    (reference ScriptCompile, batch_compile.py:34-90, which links
    -lXmipp/-lXmippCore with xmipp.conf flags; here the native surface is
    xmipp3_tpu_torch/native's libxmipp3_native.so, built first if it is
    missing)."""

    name = "xmipp_compile"

    def defineParams(self):
        self.addUsageLine(
            "Compile a C++ program using the native library of "
            "xmipp3_tpu_torch")
        self.addParamsLine(" -i <cpp_file>   : C++ file to compile")
        self.addParamsLine("   alias --input;")
        self.addParamsLine(" [--debug]       : Compile with debugging flags")
        self.addParamsLine(" [-o <out=\"\">]   : Output binary (default: "
                           "source name without .cpp)")

    def run(self):
        from xmipp3_tpu_torch import native
        src = self.getParam("-i")
        if not (src.endswith(".cpp") or src.endswith(".cc")):
            raise ValueError("Please provide a .cpp/.cc file to compile")
        out = self.getParam("-o") or os.path.splitext(src)[0]
        opt = ["-g", "-O0"] if self.checkParam("--debug") else ["-O2"]
        cmd = ["g++", "-std=c++17", *opt, src, f"-I{native.INCLUDE_DIR}",
               "-o", out]
        if native.build():
            cmd += [f"-L{native.LIB_DIR}", "-lxmipp3_native",
                    f"-Wl,-rpath,{native.LIB_DIR}"]
        if self.verbose:
            print(" ".join(cmd))
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stderr)
            raise RuntimeError(f"compilation failed: {' '.join(cmd)}")
        print(f"compiled {out}")


class ProgTestScriptImportingModule(XmippProgram):
    """Self-test that user scripts can import xmippPyModules
    (batch_test_script_importing_module.py — gtest-styled output)."""

    name = "xmipp_test_script_importing_module"

    def defineParams(self):
        self.addUsageLine(
            "Test/example of a script importing from xmippPyModules.")

    def read(self, argv):
        self._help_requested = any(a in ("-h", "--help") for a in argv[1:])
        if self._help_requested:
            print(self.usage())

    def run(self):
        print("[ RUN      ] test_script_importing_module")
        from xmipp3_tpu_torch.binding.xmippPyModules import example_module
        print(example_module.anyFunction())
        print(example_module.anyClass.getFromClassMethod())
        print(example_module.anyClass().getFromObjectMethod())
        from xmipp3_tpu_torch.binding.xmippPyModules.example_module2 import \
            example_inmodule2
        print(example_inmodule2.anyFunction2())
        print(example_inmodule2.anyClass2.getFromClassMethod2())
        print(example_inmodule2.anyClass2().getFromObjectMethod2())
        print("[       OK ] test_script_importing_module")
