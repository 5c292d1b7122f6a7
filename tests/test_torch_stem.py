"""Kernel K2 (stem_packed) of the PyTorch port against the reference
package's Pallas stem kernel run in interpret mode and its plain-conv
oracle, on the same numpy inputs.

Tolerances: f32 1e-5 of the output's scale (the same 27 f32 terms, summed
in the same order against the kernel, in another against the conv); bf16
one bf16 ulp (2^-8) of the output's largest value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bp_from_video_tpu.pallas import stem_kernel as jsk
from bp_from_video_tpu_torch.kernels import stem as tsk


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


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("cout,half,with_alpha", [(24, 32, False),
                                                  (16, 16, True),
                                                  (8, 7, True)])
def test_stem_packed_matches_pallas_and_reference(cout, half, with_alpha, dt):
    rng = np.random.default_rng(7)
    jd, td = _DT[dt]
    crops = rng.uniform(0, 1, (3, 12, half, half)).astype(np.float32)
    w = rng.normal(0, 0.2, (3, 3, 3, cout)).astype(np.float32)
    b = rng.normal(0, 0.1, (cout,)).astype(np.float32)
    alpha = (rng.uniform(0.05, 0.5, (cout,)).astype(np.float32)
             if with_alpha else None)
    ja = None if alpha is None else jnp.asarray(alpha)
    ta = None if alpha is None else torch.from_numpy(alpha)
    jc, jw = jnp.asarray(crops, jd), jnp.asarray(w, jd)
    kern = _f32(jsk.stem_packed(jc, jw, jnp.asarray(b), ja, interpret=True))
    ref = _f32(jsk.stem_packed_reference(jc, jw, jnp.asarray(b), ja))
    got = tsk.stem_packed(torch.from_numpy(crops).to(td),
                          torch.from_numpy(w).to(td), torch.from_numpy(b), ta)
    assert tuple(got.shape) == (3, cout, half, half) and got.dtype == td
    tol = (1e-5 if dt == "float32" else 2.0 ** -8) * float(np.abs(ref).max())
    np.testing.assert_allclose(_f32(got), kern, atol=tol, rtol=0)
    np.testing.assert_allclose(_f32(got), ref, atol=tol, rtol=0)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,cin,cout,half", [(1, 1, 12, 13), (1, 3, 8, 7),
                                             (2, 1, 16, 13), (2, 3, 12, 7),
                                             (3, 1, 12, 13)])
def test_stem_packed_odd_shapes_match_pallas(k, cin, cout, half, dt):
    """Stems narrower than 3x3 or of one input channel, at grid sides and
    channel counts off the card kernel's runs and tiles of 8."""
    rng = np.random.default_rng(10 * k + cin)
    jd, td = _DT[dt]
    crops = rng.uniform(-1, 1, (2, 4 * cin, half, half)).astype(np.float32)
    w = rng.normal(0, 0.3, (k, k, cin, cout)).astype(np.float32)
    b = rng.normal(0, 0.1, (cout,)).astype(np.float32)
    alpha = rng.uniform(0.05, 0.5, (cout,)).astype(np.float32)
    jc, jw = jnp.asarray(crops, jd), jnp.asarray(w, jd)
    ja = jnp.asarray(alpha)
    kern = _f32(jsk.stem_packed(jc, jw, jnp.asarray(b), ja, interpret=True))
    ref = _f32(jsk.stem_packed_reference(jc, jw, jnp.asarray(b), ja))
    got = tsk.stem_packed(torch.from_numpy(crops).to(td),
                          torch.from_numpy(w).to(td), torch.from_numpy(b),
                          torch.from_numpy(alpha))
    assert tuple(got.shape) == (2, cout, half, half) and got.dtype == td
    tol = (1e-5 if dt == "float32" else 2.0 ** -8) * float(np.abs(ref).max())
    np.testing.assert_allclose(_f32(got), kern, atol=tol, rtol=0)
    np.testing.assert_allclose(_f32(got), ref, atol=tol, rtol=0)


def test_stem_packed_rejects_wide_kernels_and_bad_shapes():
    crops = torch.zeros((1, 12, 8, 8))
    b = torch.zeros(4)
    with pytest.raises(ValueError, match="k<=3"):
        tsk.stem_packed(crops, torch.zeros((5, 5, 3, 4)), b)
    with pytest.raises(ValueError):            # 4*cin planes expected
        tsk.stem_packed(crops[:, :9], torch.zeros((3, 3, 3, 4)), b)
    with pytest.raises(ValueError):            # alpha of the wrong length
        tsk.stem_packed(crops, torch.zeros((3, 3, 3, 4)), b, torch.zeros(3))
