"""The port's GPipe pipeline and its multi-rank compressed all-reduce
against the JAX package's.

- ``pipeline_apply``: the JAX package's own case (4 stages of
  ``eye(8) * (i + 1)``, a 16 x 8 input, 4 microbatches), the port on CPU
  tensors against the JAX package's ``shard_map`` pipeline on 4 forced
  host devices (run in a subprocess, as ``tests/test_torch_placed.py``
  runs its placed run), rtol 1e-5; autograd through the pipeline over 2
  pattern units of a reduced gemma3-1b against the sequential pass's
  gradients, float32 within 1e-5 of each leaf's scale; a batch that the
  microbatches do not divide raises.
- ``compressed_all_reduce`` on a ``gloo`` group of 2 processes (each rank
  its own seeded gradients, two rounds so the error feedback carries):
  the mean equals the mean of the ranks' dequantized payloads and the JAX
  package's ``compressed_psum`` over 2 host devices; the residuals equal
  theirs; float32 within 1e-6 (its own rounding of the same formula).
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.models.specs import flatten, init_tree, tree_map
from repro_torch.parallel.pipeline import bubble_fraction, pipeline_apply

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PIPE_RTOL = 1e-5
GRAD_TOL = 1e-5
REDUCE_TOL = 1e-6

# the JAX package's side of both checks, on 4 forced host devices
_JAX_SIDE = r"""
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import _make_mesh
from repro.parallel.compression import compressed_psum
from repro.parallel.pipeline import pipeline_apply

mesh = _make_mesh((4,), ("pod",))
ws = jnp.stack([jnp.eye(8) * (i + 1) for i in range(4)])
x = jnp.arange(16 * 8, dtype=jnp.float32).reshape(16, 8)
y = pipeline_apply(lambda w, xm: xm @ w, ws, x, mesh=mesh, microbatches=4)

def grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((4, 8)) * 1e-2).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}

pair = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("pod",))

def body(g, r):
    g, r = (jax.tree.map(lambda t: t[0], t) for t in (g, r))
    red, res = compressed_psum(g, "pod", r)
    return tuple(jax.tree.map(lambda t: t[None], t) for t in (red, res))

fn = jax.shard_map(body, mesh=pair, in_specs=(P("pod"), P("pod")),
                   out_specs=(P("pod"), P("pod")))
res = jax.tree.map(lambda *t: np.zeros((2,) + t[0].shape, np.float32),
                   grads(0), grads(1))
rounds = []
for rnd in range(2):
    g = jax.tree.map(lambda *t: np.stack(t), grads(2 * rnd), grads(2 * rnd + 1))
    red, res = fn(g, res)
    rounds.append({"mean": jax.tree.map(lambda t: np.asarray(t).tolist(), red),
                   "res": jax.tree.map(lambda t: np.asarray(t).tolist(), res)})
print(json.dumps({"pipeline": np.asarray(y).tolist(), "rounds": rounds}))
"""

# one rank of the port's side
_RANK = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.parallel import compression
from repro_torch.models.specs import tree_map
rank, port = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank)

def grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": torch.tensor((rng.standard_normal((4, 8)) * 1e-2)
                              .astype(np.float32)),
            "b": {"c": torch.tensor(rng.standard_normal(5)
                                    .astype(np.float32))}}

res, rounds = None, []
for rnd in range(2):
    g = grads(2 * rnd + rank)
    payload, _ = compression.compress_with_feedback(g, res)
    mean, res = compression.compressed_all_reduce(g, res)
    rounds.append({"mean": tree_map(lambda t: t.tolist(), mean),
                   "res": tree_map(lambda t: t.tolist(), res),
                   "deq": tree_map(lambda t: t.tolist(),
                                   compression.decompress(payload))})
dist.destroy_process_group()
print(json.dumps(rounds))
"""


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("REPRO_VERIFY", "REPRO_FAULTS")}
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT), env.get("PYTHONPATH", "")]))
    return env


@pytest.fixture(scope="module")
def jax_side() -> dict:
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_pipeline_matches_jax_on_its_own_case(jax_side):
    ws = torch.stack([torch.eye(8) * (i + 1) for i in range(4)])
    x = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)
    mesh = Mesh(("pod",), (4,))
    y = pipeline_apply(lambda w, xm: xm @ w, ws, x, mesh=mesh,
                       microbatches=4)
    np.testing.assert_allclose(y.numpy(), np.array(jax_side["pipeline"]),
                               rtol=PIPE_RTOL)
    np.testing.assert_allclose(y.numpy(), (x @ ws[0] @ ws[1] @ ws[2]
                                           @ ws[3]).numpy(), rtol=PIPE_RTOL)
    # explicit (repeated) stage devices run the same schedule
    y2 = pipeline_apply(lambda w, xm: xm @ w, ws, x, mesh=mesh,
                        microbatches=2, devices=["cpu"] * 4)
    assert torch.equal(y2, y)
    assert bubble_fraction(4, 4) == pytest.approx(3 / 7)


def test_pipeline_gradients_equal_the_sequential_pass():
    """Two gemma3-1b pattern units (reduced widths, float32) as two
    stages, four microbatches: the output and the gradients of every
    stacked parameter and of the input equal the sequential pass's."""
    cfg = dataclasses.replace(
        configs.get_config("gemma3-1b"), d_model=32, n_heads=2,
        n_kv_heads=1, head_dim=16, d_ff=64, vocab=128, repeats=2, tail=())
    params = init_tree(0, lm.build_specs(cfg), "cpu")["pattern"]
    rng = np.random.default_rng(1)
    x0 = torch.tensor(rng.standard_normal((8, 16, 32)).astype(np.float32))
    cot = torch.tensor(rng.standard_normal((8, 16, 32)).astype(np.float32))

    def stage(p, x):
        return lm.apply_unit(p, x, cfg)[0]

    def grads(run):
        tree = tree_map(lambda t: t.detach().clone().requires_grad_(),
                        params)
        x = x0.clone().requires_grad_()
        y = run(tree, x)
        (y * cot).sum().backward()
        return y.detach(), x.grad, {k: t.grad for k, t in flatten(tree)}

    def repeat(tree, r):
        return {k: repeat(v, r) if isinstance(v, dict) else v[r]
                for k, v in tree.items()}

    def sequential(tree, x):
        for r in range(cfg.repeats):
            x = stage(repeat(tree, r), x)
        return x

    def piped(tree, x):
        return pipeline_apply(stage, tree, x, mesh=Mesh(("pod",), (2,)),
                              microbatches=4)

    y_seq, gx_seq, g_seq = grads(sequential)
    y_pipe, gx_pipe, g_pipe = grads(piped)

    def rel(a, b):
        return float((a - b).abs().max() / max(b.abs().max(), 1e-30))

    assert rel(y_pipe, y_seq) <= GRAD_TOL
    assert rel(gx_pipe, gx_seq) <= GRAD_TOL
    assert g_seq.keys() == g_pipe.keys()
    for path, want in g_seq.items():
        assert rel(g_pipe[path], want) <= GRAD_TOL, path


def test_pipeline_rejects_a_batch_the_microbatches_do_not_divide():
    ws = torch.stack([torch.eye(4)] * 2)
    mesh = Mesh(("pod",), (2,))
    with pytest.raises(ValueError, match="does not divide"):
        pipeline_apply(lambda w, xm: xm @ w, ws, torch.ones(10, 4),
                       mesh=mesh, microbatches=4)
    with pytest.raises(ValueError, match="devices"):
        pipeline_apply(lambda w, xm: xm @ w, ws, torch.ones(8, 4),
                       mesh=mesh, devices=["cpu"] * 3)


def test_compressed_all_reduce_on_two_ranks_matches_jax(jax_side):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(rank),
                               str(port)], cwd=ROOT, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for rank in range(2)]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-4000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    for rnd, want in enumerate(jax_side["rounds"]):
        ranks = [dict(flatten(o[rnd]["mean"],
                              is_leaf=lambda v: isinstance(v, list)))
                 for o in outs]
        deq = [dict(flatten(o[rnd]["deq"],
                            is_leaf=lambda v: isinstance(v, list)))
               for o in outs]
        ref_mean = dict(flatten(want["mean"],
                                is_leaf=lambda v: isinstance(v, list)))
        ref_res = dict(flatten(want["res"],
                               is_leaf=lambda v: isinstance(v, list)))
        for path in ranks[0]:
            got = np.array(ranks[0][path])
            np.testing.assert_array_equal(got, np.array(ranks[1][path]))
            mean = (np.array(deq[0][path]) + np.array(deq[1][path])) / 2
            np.testing.assert_allclose(got, mean, rtol=0,
                                       atol=REDUCE_TOL * np.abs(mean).max())
            ref = np.array(ref_mean[path])
            for shard in ref:        # every JAX shard holds the mean
                np.testing.assert_allclose(got, shard, rtol=0,
                                           atol=REDUCE_TOL * np.abs(ref).max())
            for rank in range(2):
                res = np.array(dict(flatten(
                    outs[rank][rnd]["res"],
                    is_leaf=lambda v: isinstance(v, list)))[path])
                np.testing.assert_allclose(
                    res, np.array(ref_res[path])[rank], rtol=0,
                    atol=REDUCE_TOL * np.abs(ref_res[path]).max())
