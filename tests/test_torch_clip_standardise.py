"""PhysFormer's clip standardisation on the CPU: the plain route
(``kernels/clip_standardise.clip_standardise_plain``) against the gather and
eight-clip f32 loop the engine ran before kernel K8, the route an engine
binds when it is built, ``Engine._clip_input``'s return, what the K8
wrapper refuses before it builds anything, the merge rule K8's statistics
use (emulated in f32) and K8's source and C entries.  K8 itself runs only
on the card (``tests/test_torch_cuda.py``)."""

import ctypes
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from bp_from_video_tpu_torch import config as tconfig
from bp_from_video_tpu_torch.kernels import build
from bp_from_video_tpu_torch.kernels import clip_standardise as kcs
from bp_from_video_tpu_torch.runtime.engine import ClipState, Engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "bp_from_video_tpu_torch", "csrc",
                      "clip_standardise.cu")
_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _before(clip: ClipState, rows):
    """The engine's standardisation before K8, as it was written: the
    gather, then eight clips at a time in f32."""
    x = clip.ordered(rows)
    dims = tuple(range(1, x.ndim))
    for part in x.split(8):
        f = part.to(torch.float32)
        f -= f.mean(dims, keepdim=True)
        var = f.square().mean(dims, keepdim=True)
        part.copy_(f.mul_(torch.where(var > 0, torch.rsqrt(var), 0.0)))
    return x


def _ring(s, t, c, dtype, seed=0):
    """A ring of ``s`` streams of ``t`` crops (plus the spare slot) of c x c
    x 3 values in [0, 1] at a level and contrast of each stream's own, its
    heads rotated."""
    g = torch.Generator().manual_seed(seed)
    level = torch.rand((s, 1, 1, 1, 1), generator=g)
    crops = (level + 0.3 * torch.rand((s, t + 1, c, c, 3), generator=g)
             * torch.rand((s, 1, 1, 1, 1), generator=g)).to(dtype)
    head = torch.randint(0, t, (s,), generator=g)
    ts = torch.zeros((s, t + 1))
    return ClipState(crops, ts, head, torch.zeros(s, dtype=torch.int32))


CASES = ("rotated", "rows", "constant", "spare", "many")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", CASES)
def test_plain_equals_the_standardisation_before_k8(case, dtype):
    """Bit for bit, with rotated heads: every stream in order; a pow-2
    padded subset of rows (due streams first, a not-due one after); a
    constant clip (zeros out); a spare slot T of NaN and 1e30 that must not
    reach the output; 11 clips, across the eight-clip parts."""
    s = 11 if case == "many" else 5
    clip = _ring(s, 7, 6, _DT[dtype], seed=CASES.index(case))
    rows = None
    if case == "rows":
        rows = torch.tensor([4, 1, 3, 0])
    elif case == "constant":
        clip.crops[2, :-1] = 0.375
    elif case == "spare":
        clip.crops[:, -1] = float("nan")
        clip.crops[::2, -1] = 1e30
    got = kcs.clip_standardise_plain(clip.crops, clip.head, rows)
    want = _before(clip, rows)
    assert got.dtype == clip.crops.dtype and got.is_contiguous()
    assert got.shape == (s if rows is None else 4, 7, 6, 6, 3)
    assert torch.equal(got, want)
    if case == "constant":
        assert not bool(got[2].any())
    if case == "spare":
        clean = clip.crops.clone()
        clean[:, -1] = 0
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, kcs.clip_standardise_plain(clean, clip.head))


def _config(dtype="float32", use_pallas=True, streams=2):
    net = tconfig.PhysFormerConfig(dim=24, ff_dim=36, num_heads=4,
                                   num_layers=1, clip_frames=8, crop=32,
                                   hop=8)
    cfg = tconfig.physformer_config(streams, 48, 64, net)
    no_files = dict(face_detector_path=None, face_landmarker_path=None,
                    hand_landmarker_path=None, person_segmenter_path=None,
                    hand_lm_standin_path=None, palm_det_standin_path=None,
                    seg_standin_path=None)
    return dataclasses.replace(cfg, compute_dtype=dtype,
                               inference=dataclasses.replace(
                                   cfg.inference, use_pallas=use_pallas,
                                   **no_files))


@pytest.fixture(scope="module")
def engine():
    return Engine(_config(), device="cpu")


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_a_cpu_engine_binds_the_plain_route(dtype, use_pallas):
    """K8 takes a bf16 ring on the card alone: an engine on the CPU binds
    the plain route when it is built, whatever its dtype and
    ``use_pallas``."""
    eng = Engine(_config(dtype, use_pallas), device="cpu")
    assert eng.standardise_clips is kcs.clip_standardise_plain


def test_an_engine_without_an_rppg_net_binds_no_route():
    cfg = tconfig.EngineConfig(num_streams=1, frame_height=48,
                               frame_width=64)
    cfg = dataclasses.replace(cfg, inference=dataclasses.replace(
        cfg.inference, face_detector_path=None, face_landmarker_path=None,
        hand_landmarker_path=None, person_segmenter_path=None))
    assert Engine(cfg, device="cpu").standardise_clips is None


@pytest.mark.parametrize("due_streams", [(), (0, 1, 2, 3, 4), (1, 3, 4)])
def test_clip_input_returns_due_rows_count_and_clips(engine, due_streams):
    """(due [S], rows, due count, clips): None and None when no stream is
    due; rows None when all are; else the due streams first, padded to the
    next power of two by the first one not due; the clips are the bound
    route's of those rows."""
    s = 5
    clip = _ring(s, 8, 16, torch.float32, seed=9)
    due = torch.zeros(s, dtype=torch.bool)
    due[list(due_streams)] = True
    clip = clip._replace(new=torch.where(due, 8, 0).to(torch.int32))
    got_due, rows, n_due, x = engine._clip_input(clip)
    assert torch.equal(got_due, due) and n_due == len(due_streams)
    if not due_streams:
        assert rows is None and x is None
        return
    if len(due_streams) == s:
        assert rows is None
    else:
        assert rows.tolist() == [1, 3, 4, 0]
    assert torch.equal(x, kcs.clip_standardise_plain(clip.crops, clip.head,
                                                     rows))


@pytest.mark.parametrize("case", ["cpu ring", "float32 ring", "int32 head",
                                  "head of other streams", "empty rows"])
def test_k8_refuses_what_it_does_not_take(monkeypatch, case):
    """A CPU or non-bf16 ring, int32 heads, shapes that do not fit: a
    ValueError before anything is built."""
    def no_build(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(build, "load", no_build)
    crops = torch.zeros((2, 5, 4, 4, 3), dtype=torch.bfloat16)
    head, rows = torch.zeros(2, dtype=torch.int64), None
    if case == "float32 ring":
        crops = crops.float()
    elif case == "int32 head":
        head = head.int()
    elif case == "head of other streams":
        head = torch.zeros(3, dtype=torch.int64)
    elif case == "empty rows":
        rows = torch.zeros(0, dtype=torch.int64)
    with pytest.raises(ValueError):
        kcs.clip_standardise(crops, head, rows)


def _merge(a, b):
    """``merge`` of ``csrc/clip_standardise.cu`` in f32 on arrays of (n,
    mean, M2)."""
    (na, ma, qa), (nb, mb, qb) = a, b
    n = na + nb
    f = np.where(n > 0, nb.astype(np.float32) / np.maximum(n, 1), 0).astype(
        np.float32)
    d = mb - ma
    return (n, (ma + d * f).astype(np.float32),
            (qa + qb + d * d * na.astype(np.float32) * f).astype(np.float32))


@pytest.mark.parametrize("level", [0.5, 200.0])
def test_k8_merge_rule_keeps_f32_statistics_exact_enough(level):
    """K8's statistics as its kernels form them, in f32: groups of 32
    values (their mean, then their centred squares), merged pairwise up a
    tree.  Mean and variance within 1e-5 of float64's, also on values far
    from 0 where E[x^2] - mean^2 in f32 loses the variance."""
    rng = np.random.default_rng(3)
    x = (level + 0.1 * rng.standard_normal(1 << 16)).astype(np.float32)
    g = x.reshape(-1, 32)
    m = g.sum(1, dtype=np.float32) / np.float32(32)
    q = ((g - m[:, None]) ** 2).sum(1, dtype=np.float32)
    st = (np.full(len(g), 32, np.int64), m.astype(np.float32), q)
    while len(st[0]) > 1:
        st = _merge(tuple(a[0::2] for a in st), tuple(a[1::2] for a in st))
    mean, var = float(st[1][0]), float(st[2][0] / np.float32(st[0][0]))
    x64 = x.astype(np.float64)
    assert abs(mean - x64.mean()) <= 1e-5 * abs(x64.mean())
    assert abs(var - x64.var()) <= 1e-5 * x64.var()


def test_the_build_lists_k8_and_the_entries_match_the_wrapper():
    """``clip_standardise`` is one of the sources ``build_all`` builds, and
    each C entry takes as many parameters as the wrapper passes, pointers
    where it passes pointers."""
    assert "clip_standardise" in build.SOURCES
    src = open(SOURCE).read()
    extern = src[src.index('extern "C" {'):]
    found = dict(re.findall(r"^int (clip_\w+)\(([^)]*)\)", extern, re.M))
    assert set(found) == set(kcs.ENTRIES)
    for name, args in kcs.ENTRIES.items():
        params = [p.strip() for p in found[name].split(",")]
        assert len(params) == len(args), name
        for p, a in zip(params, args):
            assert ("*" in p) == (a is ctypes.c_void_p), (name, p)


def test_the_kernel_source_stands_alone():
    """``csrc/clip_standardise.cu`` includes no other source of the package,
    and every definition but its ``extern "C"`` entries lies in an
    anonymous namespace (internal linkage)."""
    src = open(SOURCE).read()
    includes = re.findall(r'#include\s*[<"]([^>"]+)[>"]', src)
    assert set(includes) <= {"cuda_runtime.h", "cuda_bf16.h", "stdint.h"}
    start, end = src.index("namespace {"), src.index("}  // namespace")
    assert start < end < src.index('extern "C" {')
    assert src.count("namespace {") == 1
    outside = src[:start] + src[end:]
    defs = re.findall(r"^(?:template|__global__|__device__|static|int|"
                      r"const char\*|struct|using|constexpr|bool)\b.*",
                      outside, re.M)
    assert all(d.startswith(("int clip_", "const char* kernel_error"))
               for d in defs), defs
