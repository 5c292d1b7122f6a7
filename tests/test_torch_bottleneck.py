"""Kernels K5 (bottleneck_s1) and K6 (bottleneck_chain) of the PyTorch
port against the reference package's Pallas kernels run in interpret mode,
on the same numpy inputs.

On the CPU a wrapper takes its kernel's plain version, so these tests hold
the plain versions to the TPU kernels' semantics; ``test_torch_cuda.py``
holds the CUDA kernels to the plain versions on the card.

Tolerances: f32 1e-5 of the output's scale (f32 sums in another order);
bf16 one bf16 ulp (2^-8) of the output's largest value (the same f32 sum
rounded to bf16 can land on the neighbouring value).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bp_from_video_tpu.pallas import block_kernel as jbk
from bp_from_video_tpu_torch.kernels import bottleneck as tbn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU steps on one thread: the suite runs several test
    processes at once, and PyTorch's default (a thread a core in each)
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.array(a, np.float32)


def _tol(want, dt):
    scale = float(np.abs(want).max())
    return (1e-5 if dt == "float32" else 2.0 ** -8) * scale


def _unit(rng, c, d, cout):
    """One unit's raw conv weights and its packed operands (numpy f32)."""
    w_down = rng.normal(0, 0.3, (1, 1, c, d)).astype(np.float32)
    w_dw = rng.normal(0, 0.3, (3, 3, 1, d)).astype(np.float32)
    w_up = rng.normal(0, 0.3, (1, 1, d, cout)).astype(np.float32)
    wd, wu = tbn.pack_bottleneck_weights(w_down, w_dw, w_up)
    jwd, jwu = jbk.pack_bottleneck_weights(w_down, w_dw, w_up,
                                           dtype=np.float32)
    np.testing.assert_array_equal(wd, jwd)
    np.testing.assert_array_equal(wu, jwu)
    return dict(wd=wd, wu=wu,
                bd=rng.normal(0, 0.1, d).astype(np.float32),
                ad=rng.uniform(0.1, 0.5, d).astype(np.float32),
                bu=rng.normal(0, 0.1, cout).astype(np.float32),
                au=rng.uniform(0.1, 0.5, cout).astype(np.float32))


def _both(p, names, jd, td, stack=False):
    """The named operands as (jax list, torch list); weights in the compute
    dtype, biases and slopes f32."""
    js, ts = [], []
    for n in names:
        a = np.stack([q[n] for q in p]) if stack else p[n]
        wt = n in ("wd", "wu")
        js.append(jnp.asarray(a, jd if wt else jnp.float32))
        t = torch.from_numpy(a)
        ts.append(t.to(td) if wt else t)
    return js, ts


_NAMES = ("wd", "bd", "ad", "wu", "bu", "au")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cmid,cout,h,last_act", [
    (16, 8, 16, 12, "prelu"), (32, 16, 32, 8, "prelu"),
    (16, 8, 16, 10, "none"), (16, 8, 16, 6, "relu"),
    (16, 8, 24, 7, "prelu"), (8, 4, 8, 2, "prelu")])
def test_bottleneck_s1_matches_pallas(cin, cmid, cout, h, last_act, dt):
    rng = np.random.default_rng(11)
    jd, td = _DT[dt]
    x = rng.standard_normal((2, cin, h, h)).astype(np.float32)
    r = x if cout == cin else rng.standard_normal(
        (2, cout, h, h)).astype(np.float32)
    p = _unit(rng, cin, cmid, cout)
    js, ts = _both(p, _NAMES, jd, td)
    if last_act != "prelu":
        js[5] = ts[5] = None
    want = jbk.bottleneck_s1(jnp.asarray(x, jd), jnp.asarray(r, jd), *js,
                             last_act=last_act, interpret=True)
    got = tbn.bottleneck_s1(torch.from_numpy(x).to(td),
                            torch.from_numpy(r).to(td), *ts,
                            last_act=last_act)
    assert tuple(got.shape) == want.shape and got.dtype == td
    want = _f32(want)
    np.testing.assert_allclose(_f32(got), want, atol=_tol(want, dt), rtol=0)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("bsz,c,d,h,units", [(2, 16, 8, 9, 3),
                                             (64, 16, 8, 2, 4),
                                             (6, 32, 16, 8, 2)])
def test_bottleneck_chain_matches_pallas_and_unit_calls(bsz, c, d, h, units,
                                                        dt):
    """Against the Pallas chain (the second case is large enough that the
    reference groups crops on its lane axis, at hw = 4) and, bit for bit,
    against the same units applied one call at a time."""
    rng = np.random.default_rng(12)
    jd, td = _DT[dt]
    assert bsz < 64 or jbk._chain_group(bsz, h * h, d) > 1
    x = rng.standard_normal((bsz, c, h, h)).astype(np.float32)
    ps = [_unit(rng, c, d, c) for _ in range(units)]
    js, ts = _both(ps, _NAMES, jd, td, stack=True)
    want = _f32(jbk.bottleneck_chain(jnp.asarray(x, jd), *js,
                                     last_act="prelu", interpret=True))
    xt = torch.from_numpy(x).to(td)
    got = tbn.bottleneck_chain(xt, *ts, last_act="prelu")
    assert got.dtype == td
    # A rounding that lands on the neighbouring bf16 value in one unit is
    # carried through the units after it: one ulp per unit.
    np.testing.assert_allclose(_f32(got), want,
                               atol=units * _tol(want, dt), rtol=0)
    y = xt
    for u in range(units):
        y = tbn.bottleneck_s1(y, y, *(t[u] for t in ts), last_act="prelu")
    assert torch.equal(got, y)


def test_bottleneck_wrappers_reject_bad_operands():
    rng = np.random.default_rng(0)
    p = _unit(rng, 16, 8, 16)
    _, ts = _both(p, _NAMES, jnp.float32, torch.float32)
    x = torch.zeros((1, 16, 4, 4))
    with pytest.raises(ValueError):            # unknown activation
        tbn.bottleneck_s1(x, x, *ts, last_act="relu6")
    with pytest.raises(ValueError):            # residual of the wrong width
        tbn.bottleneck_s1(x, x[:, :8], *ts)
    with pytest.raises(ValueError):            # prelu without slopes
        tbn.bottleneck_s1(x, x, *ts[:5], None, last_act="prelu")
    with pytest.raises(ValueError):            # weights in two dtypes
        tbn.bottleneck_s1(x, x, ts[0].to(torch.bfloat16), *ts[1:])
    with pytest.raises(ValueError):            # chain needs stacked weights
        tbn.bottleneck_chain(x, *ts)
