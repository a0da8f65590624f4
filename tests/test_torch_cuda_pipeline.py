"""The GPipe pipeline on the card's streams (``gpu`` marker).

- A reduced gemma3-1b's two pattern units as two stages, each on a CUDA
  stream of its own: every microbatch's output equals the sequential pass
  over it on the card bit for bit, the whole the CPU's plain schedule
  within 1e-5 (float32), and the gradients through the pipeline the
  sequential pass's within 1e-5 of each leaf's scale.
- The handoffs are ordered by events, not by luck: a stage that spins on
  its stream before it writes still hands over its result.

Without a card these tests skip.  On one they run with
``python -m pytest -m gpu tests/test_torch_cuda_pipeline.py``; this file
imports neither JAX nor the JAX package.  ``python3 chip_smoke.py`` runs
the same checks at full width (its pipeline phase).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.models.specs import flatten, init_tree, tree_map
from repro_torch.parallel.pipeline import pipeline_apply

TOL = 1e-5                      # float32: card against CPU, gradients


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python3 chip_smoke.py on one)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.gpu
def test_pipeline_on_streams_matches_sequential_and_cpu(card):
    cfg = get_config("gemma3-1b")
    cfg = dataclasses.replace(
        cfg, d_model=128, d_ff=256, head_dim=32, n_heads=4, n_kv_heads=1,
        repeats=2, tail=(),
        pattern=tuple(dataclasses.replace(b, window=64 if b.window else 0)
                      for b in cfg.pattern))
    masters = init_tree(0, lm.build_specs(cfg)["pattern"], "cpu")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 128, cfg.d_model, generator=gen)
    cot = torch.randn(8, 128, cfg.d_model, generator=gen)
    mesh = Mesh(("pod",), (2,))

    def stage(p, h):
        return lm.apply_unit(p, h, cfg)[0]

    def sequential(p, h):
        for r in range(cfg.repeats):
            h = stage(tree_map(lambda t: t[r], p), h)
        return h

    def run(fn, device):
        p = tree_map(lambda t: t.to(device).requires_grad_(), masters)
        h = x.to(device).requires_grad_()
        y = fn(p, h)
        (y * cot.to(device)).sum().backward()
        return y.detach(), [h.grad] + [t.grad for _, t in flatten(p)]

    def piped(p, h):
        return pipeline_apply(stage, p, h, mesh=mesh, microbatches=4,
                              devices=[card] * 2)

    y, g = run(piped, card)
    with torch.no_grad():
        p = tree_map(lambda t: t.to(card), masters)
        for got, xm in zip(y.split(2), x.to(card).split(2)):
            assert torch.equal(got, sequential(p, xm))
    y_seq, g_seq = run(sequential, card)
    assert _rel(y, y_seq) <= TOL
    for a, b in zip(g, g_seq):
        assert _rel(a, b) <= TOL
    y_cpu, _ = run(lambda p, h: pipeline_apply(stage, p, h, mesh=mesh,
                                               microbatches=4), "cpu")
    assert _rel(y.cpu(), y_cpu) <= TOL


@pytest.mark.gpu
def test_pipeline_handoffs_wait_for_a_slow_stage(card):
    ws = torch.stack([torch.eye(64, device=card) * (i + 2) for i in range(3)])

    def stage(w, h):
        torch.cuda._sleep(2_000_000)         # spin on this stage's stream
        return h @ w

    x = torch.randn(16, 64, device=card)
    y = pipeline_apply(stage, ws, x, mesh=Mesh(("pod",), (3,)),
                       microbatches=4, devices=[card] * 3)
    torch.testing.assert_close(y, x * 24.0, rtol=0, atol=1e-4)
