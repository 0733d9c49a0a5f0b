"""``isegprobe_torch/utils/jax_rng.py`` against ``jax.random`` and flax.

Keys, folds, splits and raw bits must be equal bit for bit. Float samples
go through XLA's float32 arithmetic, which the port reproduces step by step
(fused multiply-adds included) except for ``log1p`` inside ``erf_inv``:
they must lie within ``ULP_BOUND`` ulp of the largest magnitude of JAX's
output (the largest gap measured is 2 ulp; uniform and xavier_uniform, which
need no log1p, are exact).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from isegprobe_torch.utils import jax_rng

ULP_BOUND = 2
KEYS = [(0, 0), (42, 7), (3, 2**32 - 1)]
SHAPES = [(7,), (3, 5), (65537,)]


def _ulps(got, want):
    want = np.asarray(want, np.float32)
    assert got.dtype == np.float32 and got.shape == want.shape
    scale = np.spacing(np.float32(np.abs(want).max()))
    return float(np.abs(got - want).max() / scale)


@pytest.mark.parametrize("seed,data", KEYS)
def test_key_fold_in_split_bitwise(seed, data):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(jax_rng.prng_key(seed), np.asarray(key))
    np.testing.assert_array_equal(jax_rng.fold_in(jax_rng.prng_key(seed),
                                                  data),
                                  np.asarray(jax.random.fold_in(key, data)))
    np.testing.assert_array_equal(jax_rng.split(jax_rng.prng_key(seed), 5),
                                  np.asarray(jax.random.split(key, 5)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 42])
def test_bits_bitwise(seed, shape):
    want = jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32)
    np.testing.assert_array_equal(jax_rng.bits32(jax_rng.prng_key(seed),
                                                 shape), np.asarray(want))


def test_truncated_normal_erf_constants():
    """The two hard-coded erf bounds of truncated_normal(-2, 2) are XLA's
    float32 values."""
    sqrt2 = jnp.float32(np.sqrt(2))
    for bound, got in zip((-2.0, 2.0), jax_rng.TRUNC2_ERF):
        want = np.float32(jax.lax.erf(jnp.float32(bound) / sqrt2))
        assert got.view(np.uint32) == want.view(np.uint32)


@pytest.mark.parametrize("name", ["uniform", "uniform_pm1", "normal",
                                  "truncated_normal", "erf_inv"])
def test_samples_within_ulp_bound(name):
    key, nkey, shape = jax.random.PRNGKey(5), jax_rng.prng_key(5), (384, 1152)
    if name == "uniform":
        want, got = (jax.random.uniform(key, shape),
                     jax_rng.uniform(nkey, shape))
    elif name == "uniform_pm1":
        want, got = (jax.random.uniform(key, shape, minval=-1.0),
                     jax_rng.uniform(nkey, shape, -1.0, 1.0))
    elif name == "normal":
        want, got = jax.random.normal(key, shape), jax_rng.normal(nkey, shape)
    elif name == "truncated_normal":
        want = jax.random.truncated_normal(key, -2, 2, shape)
        got = jax_rng.truncated_normal(nkey, shape)
    else:
        u = jax.random.uniform(key, shape, minval=-1.0)
        want, got = jax.lax.erf_inv(u), jax_rng.erf_inv(np.asarray(u))
    exact = name.startswith("uniform")
    assert _ulps(got, want) <= (0 if exact else ULP_BOUND)


@pytest.mark.parametrize("name,shape", [
    ("lecun_normal", (384, 1152)), ("lecun_normal", (3, 3, 384, 384)),
    ("lecun_normal", (14, 14, 3, 384)), ("xavier_uniform", (1212, 404)),
    ("truncated_normal_0.02", (1, 1370, 384)), ("normal_1", (2, 5, 20))])
def test_flax_initializers_within_ulp_bound(name, shape):
    key, nkey = jax.random.PRNGKey(11), jax_rng.prng_key(11)
    inits = {
        "lecun_normal": (nn.initializers.lecun_normal(),
                         jax_rng.lecun_normal),
        "xavier_uniform": (nn.initializers.xavier_uniform(),
                           jax_rng.xavier_uniform),
        "truncated_normal_0.02": (nn.initializers.truncated_normal(0.02),
                                  jax_rng.truncated_normal_init(0.02)),
        "normal_1": (nn.initializers.normal(1.0), jax_rng.normal_init(1.0)),
    }
    flax_init, port_init = inits[name]
    want = flax_init(key, shape, jnp.float32)
    got = port_init(nkey, shape)
    assert _ulps(got, want) <= (0 if name == "xavier_uniform" else ULP_BOUND)


class _Keys(nn.Module):
    """Each param's value is the raw key flax hands its init function."""

    n: int = 3

    @nn.compact
    def __call__(self, x):
        for i in range(self.n):
            self.param(f"p{i}", lambda k: jax.random.key_data(k)
                       if jnp.issubdtype(k.dtype, jax.dtypes.prng_key)
                       else k)
        return x


class _Tree(nn.Module):
    def setup(self):
        self.blocks = [_Keys(name=f"blocks_{i}") for i in range(2)]
        self.top = _Keys(n=1)
        self.outer = _Nested()

    def __call__(self, x):
        x = self.top(x)
        for blk in self.blocks:
            x = blk(x)
        return self.outer(x)


class _Nested(nn.Module):
    @nn.compact
    def __call__(self, x):
        return _Keys(name="Dense_0")(_Keys(n=2, name="inner")(x))


def test_flax_param_key_matches_flax():
    tree = _Tree().init(jax.random.PRNGKey(0), 1.0)["params"]
    root = jax_rng.prng_key(0)
    cases = [(("top",), 1), (("blocks_0",), 1), (("blocks_0",), 2),
             (("blocks_1",), 3), (("outer", "inner"), 2),
             (("outer", "Dense_0"), 1), (("outer", "Dense_0"), 3)]
    for path, counter in cases:
        node = tree
        for name in path:
            node = node[name]
        np.testing.assert_array_equal(
            jax_rng.flax_param_key(root, path, counter),
            np.asarray(node[f"p{counter - 1}"]), err_msg=str((path, counter)))
