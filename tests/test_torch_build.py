"""The port's C ABI contract, read from source text alone (no ``nvcc``).

``ops/_build.py`` compiles each ``csrc/*.cu`` source into a library and binds
the C entry points named in ``KERNELS`` with ``ctypes``; the wrappers in
``ops/flash_attention.py`` and ``ops/paged_attention.py`` call them through
``_build.launch(library, entry, what, *args)``.  A kernel source can only be
compiled on the card's machine, so these tests hold the three sides to each
other here: every source exists, every entry point is an ``extern "C"``
function of it with as many parameters as its ``argtypes``, and every launch
names a library and entry of ``KERNELS`` with that many arguments.
"""

import ast
import re
from pathlib import Path

import pytest
import torch

from accelerate_tpu_torch.ops import _build
from accelerate_tpu_torch.ops import paged_attention as pa

OPS = Path(_build.__file__).resolve().parent
WRAPPERS = ("flash_attention.py", "paged_attention.py")

ENTRIES = [(lib, entry, argtypes) for lib, (_, entries) in sorted(_build.KERNELS.items())
           for entry, argtypes in sorted(entries.items())]


def _c_params(source: str, entry: str):
    """Parameter list of ``extern "C" <type> entry(...)`` in ``source``."""
    m = re.search(r'extern\s+"C"\s+[\w\s\*]+?\b' + re.escape(entry) + r"\s*\(([^)]*)\)", source)
    assert m, f'no extern "C" definition of {entry}'
    return [p.strip() for p in m.group(1).split(",") if p.strip()]


def _launches(path: Path):
    """``(library, entry, n_args, line)`` of every launch in a wrapper module:
    direct ``_build.launch("lib", "entry", what, ...)`` calls, and calls of a
    module function that forwards its own ``library``/``entry`` parameters to
    ``_build.launch``."""
    tree = ast.parse(path.read_text())
    found, forwarders = [], {}

    def is_build_launch(call):
        f = call.func
        return isinstance(f, ast.Attribute) and f.attr == "launch" \
            and isinstance(f.value, ast.Name) and f.value.id == "_build"

    for fn in (n for n in tree.body if isinstance(n, ast.FunctionDef)):
        params = [a.arg for a in fn.args.args]
        for call in (n for n in ast.walk(fn) if isinstance(n, ast.Call) and is_build_launch(n)):
            lib, entry = call.args[0], call.args[1]
            n_args = len(call.args) - 3
            if isinstance(lib, ast.Constant) and isinstance(entry, ast.Constant):
                found.append((lib.value, entry.value, n_args, call.lineno))
            else:
                assert isinstance(lib, ast.Name) and isinstance(entry, ast.Name)
                forwarders[fn.name] = (params.index(lib.id), params.index(entry.id), n_args)
    for call in (n for n in ast.walk(tree) if isinstance(n, ast.Call)):
        if isinstance(call.func, ast.Name) and call.func.id in forwarders:
            i_lib, i_entry, n_args = forwarders[call.func.id]
            found.append((call.args[i_lib].value, call.args[i_entry].value, n_args,
                          call.lineno))
    return found


@pytest.mark.parametrize("library", sorted(_build.KERNELS))
def test_kernel_source_exists(library):
    source = _build.KERNELS[library][0]
    assert (OPS / "csrc" / source).is_file()
    assert _build.CSRC == OPS / "csrc"


@pytest.mark.parametrize("library,entry,argtypes", ENTRIES,
                         ids=[f"{lib}-{entry}" for lib, entry, _ in ENTRIES])
def test_entry_point_is_extern_c_with_its_argtypes(library, entry, argtypes):
    source = (OPS / "csrc" / _build.KERNELS[library][0]).read_text()
    params = _c_params(source, entry)
    assert len(params) == len(argtypes), (entry, params)
    # every library also exports the error-string lookup that load() binds
    assert _c_params(source, "atpu_error_string") == ["int err"]


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_every_launch_names_a_known_entry_with_its_arity(wrapper):
    launches = _launches(OPS / wrapper)
    assert launches, f"{wrapper} launches no kernel"
    for library, entry, n_args, line in launches:
        assert library in _build.KERNELS, f"{wrapper}:{line}: unknown library {library!r}"
        entries = _build.KERNELS[library][1]
        assert entry in entries, f"{wrapper}:{line}: {library!r} exports no {entry!r}"
        assert n_args == len(entries[entry]), \
            f"{wrapper}:{line}: {entry} takes {len(entries[entry])} arguments, given {n_args}"


def test_every_entry_point_is_launched():
    launched = {(lib, entry) for w in WRAPPERS for lib, entry, _, _ in _launches(OPS / w)}
    assert launched == {(lib, entry) for lib, entry, _ in ENTRIES}


@pytest.mark.parametrize("dtype,code", sorted(pa._PAGE_FORMATS.items(), key=lambda kv: kv[1]),
                         ids=lambda v: str(v).replace("torch.", ""))
def test_page_dispatch_takes_every_page_format(dtype, code):
    """Both paged libraries dispatch every page format the wrappers pass
    (``_PAGE_FORMATS``) through the shared header, to the C type of that
    dtype: one build per source holds them all."""
    ctype = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16", torch.int8: "int8_t",
             torch.float8_e4m3fn: "__nv_fp8_e4m3"}[dtype]
    common = (OPS / "csrc" / "paged_common.cuh").read_text()
    assert re.search(rf"kv_fmt == {code}\) return LAUNCH\(QT, {re.escape(ctype)}, D\)", common)
    for library in ("paged_attention", "paged_prefill"):
        source = (OPS / "csrc" / _build.KERNELS[library][0]).read_text()
        assert "ATPU_DISPATCH(q_bf16, kv_fmt, d," in source


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float8_e4m3fn],
                         ids=lambda v: str(v).replace("torch.", ""))
def test_tensor_core_prefill_dispatch_takes_what_the_design_picks(dtype):
    """Every page dtype for which ``prefill_design`` picks ``"wgmma"`` has a
    tensor-core arm in ``atpu_paged_prefill``, at both of its head dims."""
    assert pa.prefill_design(torch.bfloat16, dtype, 64, 128) == "wgmma"
    ctype = {torch.bfloat16: "__nv_bfloat16", torch.int8: "int8_t",
             torch.float8_e4m3fn: "__nv_fp8_e4m3"}[dtype]
    source = (OPS / "csrc" / "paged_prefill.cu").read_text()
    code = pa._PAGE_FORMATS[dtype]
    assert re.search(rf"kv_fmt == {code}\) return ATPU_LAUNCH_PREFILL_WGMMA\(D, "
                     rf"{re.escape(ctype)}\)", source)
    for d in pa._WGMMA_HEAD_DIMS:
        assert f"ATPU_WGMMA_PAGES({d})" in source
