"""PhysFormer's stem layers on the CPU: ``pf_stem_plain`` against the
stem's arithmetic as the port ran it before kernel K7, K7's weight layout
and product (``pf_stem_gemm``, the wrapper's CPU path) against the plain
layers at the published widths, and the engine's plain stem on a CPU tensor
with the kernel flag set.  The kernel itself runs in
``tests/test_torch_cuda.py``."""

import os
import re
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F

from bp_from_video_tpu_torch import config as tconfig
from bp_from_video_tpu_torch.kernels import build
from bp_from_video_tpu_torch.kernels import pf_stem as kps
from bp_from_video_tpu_torch.models import physformer as pf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "bp_from_video_tpu_torch", "csrc", "pf_stem.cu")
SMALL = tconfig.PhysFormerConfig(dim=24, ff_dim=36, num_heads=4, num_layers=1,
                                 clip_frames=8, crop=64, hop=8)
# The published widths at crop 128, one block: the layers K7 takes.
FULL = tconfig.PhysFormerConfig(num_layers=1, clip_frames=8, hop=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stem_before_k7(net, x):
    """``PhysFormer.stem_apply`` as the port ran it before K7, kept here to
    hold ``pf_stem_plain`` to it."""
    bsz, t, hh, ww, _ = x.shape
    (w0, b0), (w1, b1), (w2, b2) = net.stem
    n, co = bsz * t, b0.shape[0]
    packed = x.reshape(n, hh // 2, 2, ww // 2, 2, 3).permute(
        0, 1, 3, 2, 4, 5).reshape(n, hh // 2, ww // 2, 12)
    y = F.conv2d(F.pad(packed, (0, 4)).permute(0, 3, 1, 2), w0, padding=1)
    m = F.relu_(y.permute(0, 2, 3, 1).unflatten(-1, (4, co)).amax(-2)
                .add_(b0))
    for w, b in ((w1, b1), (w2, b2)):
        yt = m.unflatten(0, (bsz, t))
        tt = yt.shape[1]
        yp = F.pad(yt, (0, 0) * (yt.ndim - 2) + (1, 1))
        taps = torch.cat([yp[:, :tt], yp[:, 1:tt + 1], yp[:, 2:]],
                         -1).flatten(0, 1)
        y = F.conv2d(taps.permute(0, 3, 1, 2), w, padding=1)
        nn, c, h, ww2 = y.shape
        v = y.permute(0, 2, 3, 1).reshape(nn, h // 2, 2, ww2 // 2, 2, c)
        m = F.relu_(v.amax((2, 4)).add_(b))
    return m.unflatten(0, (bsz, t))


def _clip(cfg, bsz, t, seed, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(bsz, t, cfg.crop, cfg.crop, 3, generator=g).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_plain_stem_equals_the_stem_before_k7(dtype):
    """The three ``pf_stem_plain`` layers run the old ``stem_apply``'s
    operations in its order: bit-equal."""
    net = pf.PhysFormer(SMALL, pf.init_params(SMALL, 5), dtype, "cpu")
    x = _clip(SMALL, 3, 5, 1, dtype)
    assert torch.equal(net.stem_apply(x), _stem_before_k7(net, x))


def test_stem_on_a_cpu_tensor_takes_the_plain_layers(monkeypatch):
    """With the kernel flag a CPU tensor still runs ``pf_stem_plain``: the
    same output as without the flag, no launch counted, no library
    loaded."""
    def no_load(name):
        raise AssertionError(f"loaded {name}")
    monkeypatch.setattr(build, "load", no_load)
    params = pf.init_params(FULL, 6)
    x = _clip(FULL, 1, 3, 2)
    n = kps.pf_stem.launches
    net = pf.PhysFormer(FULL, params, torch.bfloat16, "cpu", use_kernel=True)
    assert net.stem_k7 is None
    got = net.stem_apply(x)
    want = pf.PhysFormer(FULL, params, torch.bfloat16, "cpu").stem_apply(x)
    assert torch.equal(got, want)
    assert kps.pf_stem.launches == n


def _full_net(seed):
    """The published widths in bf16 on the CPU, with K7's weight layout."""
    net = pf.PhysFormer(FULL, pf.init_params(FULL, seed), torch.bfloat16,
                        "cpu")
    net.stem_k7 = [kps.kernel_weights(w, b, packed=i == 0)
                   for i, (w, b) in enumerate(net.stem)]
    return net


def _ulp(want: torch.Tensor) -> float:
    """One bf16 ulp of the largest |value|."""
    return 2.0 ** (float(torch.floor(torch.log2(want.float().abs().max())))
                   - 7)


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_kernel_layout_and_product_match_the_plain_layer(layer):
    """``pf_stem`` on a CPU tensor (``pf_stem_gemm``: the kernel's weight
    layout and k order, f32 sums, one rounding) against the plain layer, at
    the layer's published widths, an odd batch, both clip ends: at most one
    bf16 ulp of the largest output apart, since the plain layer rounds the
    conv before the bias and the kernel rounds once."""
    net = _full_net(8)
    x = _clip(FULL, 1, 3, 3)
    for w, b in net.stem[:layer]:
        x = kps.pf_stem_plain(x, w, b)
    w, b = net.stem[layer]
    want = kps.pf_stem_plain(x, w, b)
    got = kps.pf_stem(x, *net.stem_k7[layer])
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    gap = (got.float() - want.float()).abs()
    assert float(gap.max()) <= _ulp(want)
    # Most outputs agree exactly: the layouts do not scramble anything.
    assert float((gap > 0).float().mean()) < 0.3


def test_kernel_weights_follow_the_documented_layout():
    """stem1/stem2: wk[n, ((dt*3+ky)*3+kx)*cin + c] is the conv's weight
    at (n, c, dt, ky, kx), zero past 27 cin; stem0: wk[(oct*4+pos)*8 + i,
    (ky*3+kx)*16 + c] is the packed conv's output pos*cout + oct*8 + i."""
    net = _full_net(9)
    (w0, b0), (w1, b1) = net.stem[:2]
    wk0, bk0 = net.stem_k7[0]
    wk1, bk1 = net.stem_k7[1]
    cin, co = w1.shape[1] // 3, b1.shape[0]
    assert wk1.shape == (co, 656) and torch.equal(wk1[:, 27 * cin:],
                                                  torch.zeros(co, 8,
                                                              dtype=wk1.dtype))
    for n, c, dt, ky, kx in ((0, 0, 0, 0, 0), (5, 7, 2, 1, 0),
                             (47, 23, 1, 2, 2), (13, 16, 2, 2, 1)):
        assert wk1[n, ((dt * 3 + ky) * 3 + kx) * cin + c] == w1[
            n, dt * cin + c, ky, kx]
    co0 = b0.shape[0]
    assert wk0.shape == (4 * co0, 144)
    for oct_, pos, i, ky, kx, c in ((0, 0, 0, 0, 0, 0), (2, 3, 7, 2, 2, 15),
                                    (1, 2, 4, 0, 1, 11)):
        assert wk0[(oct_ * 4 + pos) * 8 + i, (ky * 3 + kx) * 16 + c] == w0[
            pos * co0 + oct_ * 8 + i, c, ky, kx]
    assert bk0.dtype == bk1.dtype == torch.float32
    assert torch.equal(bk1, b1.float()) and torch.equal(bk0, b0.float())


def test_kernel_weights_refuse_widths_the_kernel_does_not_take():
    net = pf.PhysFormer(SMALL, pf.init_params(SMALL, 11), torch.bfloat16,
                        "cpu")
    with pytest.raises(ValueError):
        kps.kernel_weights(*net.stem[0], packed=True)


@pytest.mark.parametrize("case", ["dtype", "frame", "channels", "wk"])
def test_pf_stem_refuses_what_the_kernel_does_not_take(case):
    net = _full_net(10)
    x = _clip(FULL, 1, 2, 4)
    wk, bk = net.stem_k7[0]
    if case == "dtype":
        x = x.float()
    elif case == "frame":
        x = x[:, :, :64, :64].contiguous()
    elif case == "channels":
        wk, bk = net.stem_k7[1]
    else:
        wk = wk[:, :128].contiguous()
    with pytest.raises(ValueError):
        kps.pf_stem(x, wk, bk)


def test_the_build_lists_k7_and_its_module_needs_no_nvcc():
    """``pf_stem`` is one of the sources ``build_all`` builds; the wrapper
    imports in an interpreter with no CUDA toolkit to be found."""
    assert "pf_stem" in build.SOURCES
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env.update(PATH="/nonexistent", PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c",
                        "import bp_from_video_tpu_torch.kernels.pf_stem"],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr


def test_the_kernel_source_stands_alone():
    """``csrc/pf_stem.cu`` includes no other source of the package, and
    every definition but its ``extern "C"`` entries lies in an anonymous
    namespace (internal linkage)."""
    src = open(SOURCE).read()
    includes = re.findall(r'#include\s*[<"]([^>"]+)[>"]', src)
    assert set(includes) <= {"cuda_runtime.h", "cuda_bf16.h", "stdint.h"}
    start, end = src.index("namespace {"), src.index("}  // namespace")
    extern = src.index('extern "C" {')
    assert start < end < extern
    assert src.count("namespace {") == 1
    outside = src[:start] + src[end:]
    defs = re.findall(r"^(?:template|__global__|__device__|static|int|"
                      r"const char\*|struct|using|constexpr)\b.*",
                      outside, re.M)
    assert all(d.startswith(("int pf_stem_", "const char* kernel_error"))
               for d in defs), defs
