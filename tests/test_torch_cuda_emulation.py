"""The backward CUDA kernels' logic on the CPU, by host emulation.

The CPU has no nvcc and no card, so ``flash_attention_bwd.cu`` is compiled
with g++ against ``tests/cuda_emulation/``: CUDA's qualifiers, launches and
barriers become host code (a block is 256 std::threads), and the two PTX
sections of ``hopper_mma.cuh`` are replaced by host stand-ins — cp.async as
a copy that lands at once or only when waited for, wgmma as a product
that reads each operand through its descriptor by the canonical swizzled
layouts. Everything else (tile layout, descriptors, fragment maps, the
ring, masking, the causal walk, the epilogue, the f32 kernels) is the
source as the card compiles it. The kernels are held against
``_bwd_plain`` with chip_smoke.py's limits. What this cannot show: that
nvcc accepts the source, and that the card's wgmma reads the layouts as
the stand-in does (chip_smoke.py checks both on the card).

A second check parses every CUDA source with g++ with the PTX kept, which
catches a malformed inline-asm string or operand list before a chip run.
"""

import ctypes
import math
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from raydp_tpu_torch.ops import _build
from raydp_tpu_torch.ops import flash_attention as fa

EMU = Path(__file__).resolve().parent / "cuda_emulation"
_CUDA_INCLUDES = "#include <cuda_bf16.h>\n#include <cuda_runtime.h>\n"
# (bh, t, d, dtype, causal): every bf16 head dim at a T that is no multiple
# of the 64/128-row tiles, both masks; and the f32 kernels
SHAPES = [(2, 300, 16, torch.bfloat16, True),
          (2, 200, 32, torch.bfloat16, True),
          (1, 190, 64, torch.bfloat16, False),
          (1, 256, 128, torch.bfloat16, True),
          (1, 130, 128, torch.bfloat16, False),
          (1, 100, 32, torch.float32, True)]
GRAD_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


def _gpp() -> str:
    gpp = shutil.which("g++")
    if gpp is None:
        pytest.skip("no g++ to build the host emulation")
    return gpp


def _host_source(src: str) -> str:
    """A kernel source for the host: the CUDA headers become emu.h, dynamic
    shared memory the running block's buffer, a launch a call."""
    src = src.replace(_CUDA_INCLUDES, '#include "emu.h"\n')
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = (\1*)emu_smem;", src)
    return re.sub(r"(\w+<[^<>]*>)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", src)


def _emulated_header() -> str:
    """hopper_mma.cuh with its two PTX sections replaced by the host
    stand-ins."""
    src = (_build.CSRC / "hopper_mma.cuh").read_text()
    copies = src.index("// --- PTX: copies")
    composed = src.index("// --- composed helpers")
    products = src.index("// --- PTX: m64nNk16")
    end = src.rindex("}  // namespace raydp_sm90")
    return (src[:copies] + (EMU / "ptx_copies.h").read_text()
            + src[composed:products] + (EMU / "ptx_wgmma.h").read_text()
            + src[end:])


@pytest.fixture(scope="module")
def emulated_bwd(tmp_path_factory):
    gpp = _gpp()
    out = tmp_path_factory.mktemp("cuda_emulation")
    (out / "hopper_mma.cuh").write_text(_host_source(_emulated_header()))
    for name in ("flash_attention_common.cuh", "flash_attention_bwd.cu"):
        (out / name).write_text(_host_source((_build.CSRC / name).read_text()))
    lib_path = out / "libbwd.so"
    proc = subprocess.run(
        [gpp, "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
         f"-I{out}", f"-I{EMU}", "-x", "c++", "-o", str(lib_path),
         str(out / "flash_attention_bwd.cu")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(lib_path))
    tail = [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.raydp_flash_attention_bwd_dkdv.argtypes = [ctypes.c_void_p] * 8 + tail
    lib.raydp_flash_attention_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + tail
    lib.emu_set_copy_mode.argtypes = [ctypes.c_int]
    return lib


@pytest.mark.parametrize("copies_land", ["at_once", "at_wait"])
@pytest.mark.parametrize(
    "bh,t,d,dtype,causal", SHAPES,
    ids=[f"{str(dt)[6:]}-T{t}-D{d}-{'causal' if c else 'full'}"
         for _, t, d, dt, c in SHAPES])
def test_emulated_bwd_kernels_match_plain(emulated_bwd, bh, t, d, dtype,
                                          causal, copies_land):
    """dq, dk, dv of the emulated kernels against ``_bwd_plain``:
    |got - plain| <= rtol (|plain| + rms(plain)), plus
    ``_bwd_rounding_bound`` in bf16 (the kernels round p and ds), as
    chip_smoke.py holds the card."""
    emulated_bwd.emu_set_copy_mode(0 if copies_land == "at_once" else 1)
    gen = torch.Generator().manual_seed(t + d)
    q3, k3, v3, do = [torch.randn(bh, t, d, generator=gen).to(dtype)
                      for _ in range(4)]
    scale = 1.0 / math.sqrt(d)
    out, lse = fa._fwd_plain(q3, k3, v3, scale, causal)
    delta = (do.float() * out.float()).sum(-1)
    dq, dk, dv = (torch.full_like(q3, float("nan")) for _ in range(3))
    is_bf16 = fa._KERNEL_DTYPES[dtype]
    ptrs = [x.data_ptr() for x in (q3, k3, v3, do, lse, delta)]
    assert emulated_bwd.raydp_flash_attention_bwd_dkdv(
        *ptrs, dk.data_ptr(), dv.data_ptr(), bh, t, d, scale, int(causal),
        is_bf16, None) == 0
    assert emulated_bwd.raydp_flash_attention_bwd_dq(
        *ptrs, dq.data_ptr(), bh, t, d, scale, int(causal), is_bf16,
        None) == 0
    ref = fa._bwd_plain(q3, k3, v3, out, lse, do, scale, causal)
    bounds = (fa._bwd_rounding_bound(q3, k3, v3, out, lse, do, scale, causal)
              if dtype == torch.bfloat16 else (0.0, 0.0, 0.0))
    for name, got, want, bound in zip(("dq", "dk", "dv"), (dq, dk, dv), ref,
                                      bounds):
        got, want = got.float(), want.float()
        limit = (GRAD_RTOL[dtype] * (want.abs() + want.square().mean().sqrt())
                 + bound)
        used = ((got - want).abs() / limit).max().item()
        assert used <= 1.0, f"{name} uses {used:.3f} of its limit"


def test_emulated_bwd_refuses_unaligned_bf16(emulated_bwd):
    """cp.async copies 16 bytes: a bf16 tensor off a 16-byte boundary is
    refused before any launch (cudaErrorMisalignedAddress)."""
    x = torch.zeros(1, 64 * 16 + 8, dtype=torch.bfloat16)
    q3 = x[:, 8:].view(1, 64, 16)                     # 16 bytes + 16 off
    bad = x[:, 1:1 + 64 * 16].view(1, 64, 16)         # 2 bytes off
    rows = torch.zeros(1, 64)
    ptrs = [q3.data_ptr(), bad.data_ptr(), q3.data_ptr(), q3.data_ptr(),
            rows.data_ptr(), rows.data_ptr()]
    assert emulated_bwd.raydp_flash_attention_bwd_dq(
        *ptrs, q3.data_ptr(), 1, 64, 16, 0.25, 1, 1, None) == 716


@pytest.mark.parametrize("name", ["flash_attention_fwd.cu",
                                  "flash_attention_bwd.cu"])
def test_cuda_sources_parse_with_ptx_kept(tmp_path, name):
    """Every CUDA source, with its inline PTX as written, parses and
    type-checks under g++ (-fsyntax-only, templates instantiated)."""
    gpp = _gpp()
    for src in _build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (tmp_path / src.name).write_text(_host_source(src.read_text()))
    proc = subprocess.run(
        [gpp, "-std=c++20", "-fsyntax-only", f"-I{tmp_path}", f"-I{EMU}",
         "-Wno-unknown-pragmas", "-x", "c++", str(tmp_path / name)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
