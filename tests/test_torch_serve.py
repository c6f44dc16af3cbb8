"""The port's serving engine (`repro_torch.serve.engine`) and its CLI
against the JAX package on the CPU.  In f32 compute both engines must
return the same tokens: the wave scheduling, teacher forcing and host-side
argmax are the same code, and the logits agree to about 1e-6
(tests/test_torch_lm.py), far inside the top-2 margins of these prompts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced_config as jreduced_config
from repro.core.cas import TierTracker as JTierTracker
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.core.cas import TierTracker
from repro_torch.models import lm
from repro_torch.serve import engine


def _serve_both(arch, seed, prompts, max_new, slots, max_len):
    jcfg = jreduced_config(jget_config(arch))
    cfg = reduced_config(get_config(arch))
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    params = lm.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                         jparams), "cpu")
    jeng = jengine.ServeEngine(jcfg, jparams, batch_slots=slots,
                               max_len=max_len, dtype=jnp.float32)
    eng = engine.ServeEngine(cfg, params, batch_slots=slots,
                             max_len=max_len, dtype=torch.float32,
                             device="cpu")
    for rid, p in enumerate(prompts):
        jeng.submit(jengine.Request(rid=rid, prompt=p, max_new=max_new))
        eng.submit(engine.Request(rid=rid, prompt=p, max_new=max_new))
    jdone = {r.rid: r.out for r in jeng.run_until_drained()}
    done = {r.rid: r.out for r in eng.run_until_drained()}
    return done, jdone


def test_serve_engine_returns_the_jax_tokens():
    """tests/test_runtime.py's two requests on reduced qwen1.5-0.5b."""
    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    done, jdone = _serve_both("qwen1p5_0p5b", 5, [prompt, prompt[:3]],
                              max_new=4, slots=2, max_len=32)
    assert done == jdone
    assert all(len(v) == 4 for v in done.values())


def test_serve_engine_hybrid_two_waves_returns_the_jax_tokens():
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (7, 3, 12)]
    done, jdone = _serve_both("zamba2_2p7b", 6, prompts, max_new=5,
                              slots=2, max_len=24)
    assert done == jdone and sorted(done) == [0, 1, 2]
    assert all(len(v) == 5 for v in done.values())


def test_replica_router_prefers_quiet_tier():
    """tests/test_runtime.py's router case, on both packages."""
    routes = []
    for tracker, router in ((TierTracker, engine.ReplicaRouter),
                            (JTierTracker, jengine.ReplicaRouter)):
        tt = tracker(keys=[0, 1], thresholds=[1.2])
        for _ in range(3):
            tt.update({0: 9.0, 1: 0.5})
        r = router(2, tiers=tt)
        routes.append([r.route() for _ in range(3)])
    assert routes[0] == routes[1] == [1, 1, 1]


def test_replica_router_releases_load_with_the_engine():
    r = engine.ReplicaRouter(2)
    req = engine.Request(rid=0, prompt=np.array([1], np.int32))
    assert r.assign(req) == 0 and r.load.tolist() == [1, 0]
    r.complete(req)
    assert r.load.tolist() == [0, 0] and req.replica is None
    with pytest.raises(ValueError):
        r.release(1)


def test_serve_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "zamba2-2.7b", "--reduced", "--device", "cpu",
                "--requests", "3", "--max-new", "2"])
    out = capsys.readouterr().out
    assert "served 3 requests / 6 tokens" in out and "on cpu" in out
