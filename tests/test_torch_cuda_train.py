"""Training on the card (``gpu`` marker): a reduced gemma3 config's float32
loss and gradients on the card against the CPU's, ``grad_bf16`` on the
card, and one train step there.

Without a card these tests skip.  On one they run with
``python -m pytest -m gpu tests/test_torch_cuda_train.py``; this file
imports neither JAX nor the JAX package.  ``python3 chip_smoke.py`` runs
the same checks at full width (its training phase).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import layers, lm
from repro_torch.models.specs import flatten, init_tree, tree_map
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.train.step import make_train_step

LOSS_TOL, GRAD_TOL = 1e-5, 1e-3      # float32, card against CPU


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python3 chip_smoke.py on one)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cfg():
    cfg = get_config("gemma3-1b")
    pattern = tuple(dataclasses.replace(b, window=64 if b.window else 0)
                    for b in cfg.pattern)
    return dataclasses.replace(cfg, d_model=256, d_ff=512, vocab=4096,
                               head_dim=64, repeats=1, pattern=pattern,
                               tail=())


def _loss_and_grads(cfg, tokens, device):
    """Weights drawn on the CPU (a card's generator draws other values)."""
    params = tree_map(lambda t: t.to(device).requires_grad_(),
                      init_tree(0, lm.build_specs(cfg), "cpu"))
    loss, _ = lm.forward_loss(params, cfg, {"tokens": tokens.to(device)},
                              dtype=torch.float32)
    loss.backward()
    return float(loss.detach()), {k: t.grad.cpu() for k, t in flatten(params)}


@pytest.mark.gpu
def test_card_f32_loss_and_grads_match_cpu(card):
    """One gemma3 pattern unit at d_model 256, 2 x 128 tokens: the loss
    within 1e-5 (relative), every gradient within 1e-3 of its scale."""
    cfg = _cfg()
    tokens = TokenPipeline(DataConfig(cfg.vocab, 128, 2)).batch_at(0)["tokens"]
    loss, grads = _loss_and_grads(cfg, tokens, card)
    cpu_loss, cpu_grads = _loss_and_grads(cfg, tokens, "cpu")
    assert abs(loss - cpu_loss) <= LOSS_TOL * abs(cpu_loss)
    for path, want in cpu_grads.items():
        err = float((grads[path] - want).abs().max() / want.abs().max())
        assert err <= GRAD_TOL, (path, err)


@pytest.mark.gpu
def test_grad_bf16_and_a_train_step_on_the_card(card):
    """``grad_bf16`` on the card keeps a bfloat16 input's gradient bfloat16
    and a float32 input's float32 and unchanged; one bfloat16 train step
    there gives finite metrics and new float32 parameters on the card."""
    g = torch.randn(4, 8, device=card)
    xb = torch.randn(4, 8, device=card, dtype=torch.bfloat16,
                     requires_grad=True)
    layers.grad_bf16(xb).backward(g.to(torch.bfloat16))
    assert xb.grad.dtype == torch.bfloat16 and xb.grad.device.type == "cuda"
    x = torch.randn(4, 8, device=card, requires_grad=True)
    layers.grad_bf16(x).backward(g)
    assert x.grad.dtype == torch.float32 and torch.equal(x.grad, g)

    cfg = _cfg()
    params = init_tree(0, lm.build_specs(cfg), card)
    batch = TokenPipeline(DataConfig(cfg.vocab, 128, 2),
                          device=card).batch_at(0)
    new, opt, metrics = make_train_step(cfg, AdamWConfig())(
        params, adamw.init(params), batch)
    assert all(torch.isfinite(v).all() for v in metrics.values())
    for (path, a), (_, b) in zip(flatten(new), flatten(params)):
        assert a.device.type == "cuda" and a.dtype == torch.float32, path
    assert int(opt.step) == 1
