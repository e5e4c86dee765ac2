"""The port's LM ``Server`` against the JAX package's, on the CPU.

Both servers get one set of weights (the JAX ``init_params`` at
``smoke()`` of phi3-mini-3.8b, and of granite-moe-3b-a800m,
deepseek-v3-671b, mamba2-2.7b and recurrentgemma-9b for the moe,
mla_moe, ssm and griffin decode, float32, carried leaf for leaf) and the
same requests: the scenario of ``test_train_serve.py::test_server_end_to_end``
and the request set of ``examples/ycsb_serve.py``.  They must emit the
same token streams (greedy argmax of float32 logits that agree to ~1e-6,
so ties would have to fall within that; none does for these seeds), end
with a bit-identical session table, count the same index queries and
windows, and answer ``session_range`` alike.  With ``wal_dir`` each
package recovers the other's durability directory to the other's live
table, bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke as jsmoke
from repro.launch import serve as jserve
from repro.models.base import init_params as jinit_params
from repro.models.transformer import model_layout as jmodel_layout
from repro.pipeline import recover as jrecover
from repro_torch.configs import get_config, smoke
from repro_torch.core import index as tpi
from repro_torch.launch import serve as tserve
from repro_torch.models.base import params_from_numpy
from repro_torch.pipeline import recover as trecover
from torch_parity import assert_same_state

ARCHS = ["phi3-mini-3.8b", "granite-moe-3b-a800m", "deepseek-v3-671b",
         "mamba2-2.7b", "recurrentgemma-9b"]


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    """(JAX config, port config, JAX params, the port's copy of them)."""
    jcfg = jsmoke(jget_config(request.param))
    tcfg = smoke(get_config(request.param))
    jparams = jinit_params(jmodel_layout(jcfg), jax.random.key(0),
                           jcfg.param_dtype)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def servers(weights, tmp_path=None, torch_backend="torch", **kw):
    jcfg, tcfg, jparams, tparams = weights
    jkw, tkw = dict(kw), dict(kw)
    if tmp_path is not None:
        jkw["wal_dir"] = str(tmp_path / "jax")
        tkw["wal_dir"] = str(tmp_path / "port")
    jsrv = jserve.Server(jcfg, jparams, **jkw)
    tsrv = tserve.Server(tcfg, tparams, index_backend=torch_backend,
                         device="cpu", **tkw)
    return jsrv, tsrv


def requests(pkg, n, prompt_len, max_new, rid0, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [pkg.Request(rid=rid0 + i, prompt=rng.integers(0, vocab,
                                                          prompt_len),
                        max_new=max_new) for i in range(n)]


def end_to_end(pkg, srv, vocab):
    """The scenario of ``test_train_serve.py::test_server_end_to_end``,
    with a ``session_range`` over the live sessions midway."""
    reqs = requests(pkg, 6, 5, 4, 100, vocab)
    assert srv.admit(reqs[:4]) == 4
    ranges = [srv.session_range(100, 103), srv.session_range(101, 102)]
    done = set()
    for _ in range(10):
        done.update(srv.tick())
        if len(done) == 4:
            break
    assert done == {100, 101, 102, 103}
    assert srv.admit(reqs[4:]) == 2
    ranges.append(srv.session_range(0, 1 << 30))
    return [r.out for r in reqs], ranges


def ycsb_serve(pkg, srv, vocab):
    """The request loop of ``examples/ycsb_serve.py``."""
    waiting = requests(pkg, 10, 6, 6, 1000, vocab)
    allreqs = list(waiting)
    ticks = 0
    while waiting or srv.live:
        if waiting and srv.free:
            n = srv.admit(waiting[:len(srv.free)])
            waiting = waiting[n:]
        srv.tick()
        ticks += 1
        assert ticks <= 100, "server did not drain"
    return [r.out for r in allreqs], [srv.session_range(0, 1 << 30)]


def assert_same_serving(jsrv, tsrv, jout, tout):
    assert tout == jout, "token streams differ"
    assert tsrv.queries_processed == jsrv.queries_processed
    js, ts = jsrv.pipeline_metrics.summary(), tsrv.pipeline_metrics.summary()
    assert ts["windows"] == js["windows"]
    assert ts["rebuilds"] == js["rebuilds"]
    assert_same_state(jsrv.table, tsrv.table, "session table")
    assert tsrv.slot_of == jsrv.slot_of and tsrv.free == jsrv.free


@pytest.mark.parametrize("scenario, kw", [
    (end_to_end, dict(n_slots=4, max_len=32)),
    (ycsb_serve, dict(n_slots=4, max_len=48)),
], ids=["end_to_end", "ycsb_serve"])
def test_server_matches_jax(weights, scenario, kw):
    jsrv, tsrv = servers(weights, **kw)
    vocab = weights[0].vocab
    (jout, jranges), (tout, tranges) = (scenario(jserve, jsrv, vocab),
                                        scenario(tserve, tsrv, vocab))
    assert sum(map(len, tout)) > 0
    assert_same_serving(jsrv, tsrv, jout, tout)
    assert tranges == jranges
    assert jranges[-1][0] == int(jsrv.table.live_count)


def test_server_cuda_backend_matches_torch(weights):
    """The session table on the ``cuda`` backend (the kernels' plain
    versions on the CPU) serves exactly as on ``torch``."""
    _, tcfg, _, tparams = weights
    a = tserve.Server(tcfg, tparams, n_slots=4, max_len=32,
                      index_backend="cuda", device="cpu")
    b = tserve.Server(tcfg, tparams, n_slots=4, max_len=32,
                      index_backend="torch", device="cpu")
    outs = [end_to_end(tserve, s, tcfg.vocab) for s in (a, b)]
    assert outs[0] == outs[1]
    assert all(torch.equal(x, y) for x, y in zip(
        tpi.flat_leaves(a.table), tpi.flat_leaves(b.table)))


def test_durability_dirs_interchange(weights, tmp_path):
    """Each package recovers the other's WAL + snapshots to the other's
    live session table, and its own to its own."""
    jsrv, tsrv = servers(weights, tmp_path, n_slots=4, max_len=32,
                         snapshot_every=3)
    vocab = weights[0].vocab
    jout, _ = end_to_end(jserve, jsrv, vocab)
    tout, _ = end_to_end(tserve, tsrv, vocab)
    assert tout == jout
    jsrv.close()
    tsrv.close()
    for directory in (tmp_path / "jax", tmp_path / "port"):
        got, _ = trecover(str(directory), device="cpu")
        assert_same_state(jsrv.table, got, f"port recovers {directory.name}")
        jgot, _ = jrecover(str(directory))
        assert_same_state(jgot, tsrv.table, f"JAX recovers {directory.name}")


def test_server_default_device_needs_a_card(weights):
    """The entry point builds on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, tcfg, _, tparams = weights
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.Server(tcfg, tparams, n_slots=4, max_len=32)
