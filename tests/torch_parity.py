"""Helpers for the parity tests between the JAX package and its PyTorch port.

State crosses between the packages as numpy arrays in the leaf order of
``PIIndex.tree_flatten`` (``levels`` a tuple); the port's
``from_numpy_leaves`` / ``to_numpy_leaves`` are the two ends.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import PIConfig as JaxConfig
from repro_torch.core import PIConfig as TorchConfig
from repro_torch.core import index as tpi

LEAF_NAMES = ("keys", "vals", "tomb", "n", "levels", "pkeys", "pvals",
              "ptomb", "pn", "n_updates", "overflow")

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """A module's torch ops on one intra-op thread, for the modules that
    import this fixture: their ops are small, and every core's threads in
    each of the suite's workers at once cost several times the work
    (``test_torch_bitonic_plan.py``'s halves: 1231 s and 1209 s in the
    suite, ~110 s after; ``test_torch_sharded.py`` and
    ``test_torch_train.py``: 802.0 s and 771.0 s in the suite)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# JAX backend -> the port's counterpart
BACKEND_OF = {"xla": "torch", "pallas-interpret": "cuda"}


def configs(backend="pallas-interpret", **kw):
    """A JAX config and the port's config of the same geometry."""
    jcfg = JaxConfig(backend=backend, **kw)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JaxConfig)}
    fields["backend"] = BACKEND_OF[backend]
    return jcfg, TorchConfig(**fields)


def jax_leaves(index):
    """A JAX ``PIIndex``'s leaves as numpy arrays (levels a tuple)."""
    children, _ = index.tree_flatten()
    return [tuple(np.asarray(x) for x in c) if isinstance(c, tuple)
            else np.asarray(c) for c in children]


def to_torch(index, tcfg):
    """The port's ``PIIndex`` holding a JAX index's state, on the CPU."""
    return tpi.from_numpy_leaves(tcfg, jax_leaves(index), device="cpu")


def to_jax(index, jcfg):
    """A JAX ``PIIndex`` holding the state of the port's index."""
    import jax.numpy as jnp
    from repro.core.index import PIIndex as JaxIndex
    leaves = [tuple(map(jnp.asarray, leaf)) if isinstance(leaf, tuple)
              else jnp.asarray(leaf) for leaf in tpi.to_numpy_leaves(index)]
    return JaxIndex.tree_unflatten(jcfg, leaves)


def assert_same_state(jax_index, torch_index, tag=""):
    """Every leaf equal in value and dtype, dead pending lanes included."""
    want = jax_leaves(jax_index)
    got = tpi.to_numpy_leaves(torch_index)
    assert len(want) == len(got) == len(LEAF_NAMES)
    for name, w, g in zip(LEAF_NAMES, want, got):
        if isinstance(w, tuple):
            assert len(w) == len(g), f"{tag}: {name} count"
            pairs = list(zip(w, g))
        else:
            pairs = [(w, g)]
        for i, (a, b) in enumerate(pairs):
            assert a.dtype == b.dtype, f"{tag}: {name}[{i}] dtype"
            np.testing.assert_array_equal(a, b, err_msg=f"{tag}: {name}[{i}]")


def t(a):
    """numpy → CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(a))


def ref_results(ref, ops, keys, vals):
    """RefIndex results as the (found, val) arrays execute returns."""
    res = ref.execute(ops, keys, vals)
    return (np.array([r is not None for r in res]),
            np.array([0 if r is None else r for r in res], np.int64))
