"""The port's compute session against the JAX package's, end to end.

For mlc / tlc / reduced-mlc x {1, 2, 4} dies at 1 kB pages, the port's CPU
session (``sim`` backend) and ``repro.api.ComputeSession(backend="sim")``
take the same writes and expressions.  Both must equal the numpy oracle,
book the same plan structure (sense items, batches, waves, fused calls,
executor misses/hits/traces) and the same ledger makespan.  Their Vth noise
comes from different generators, so words are compared bit for bit only
after the port's arena is loaded with the reference arena's rows.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.api import ComputeSession as RefSession
from repro.flash.geometry import SSDConfig as RefConfig
from repro_torch.api import session as port_session
from repro_torch.api.executor import MAX_FUSED_OPERANDS
from repro_torch.api.hostio import to_numpy
from repro_torch.api.session import ComputeSession
from repro_torch.flash.geometry import SSDConfig
from repro_torch.kernels import cuda

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
COUNTERS = ("sense_items", "sense_batches", "sense_waves", "megakernel_calls",
            "in_flash_senses", "fused_reduce_calls", "tiled_megakernel_splits")
N_BITS = 2 * 8192 + 100          # two 1 kB pages and a ragged tail


def _sessions(encoding: str, dies: int, **kw):
    cfg = dict(channels=1, dies_per_channel=dies, page_kb=1)
    ref = RefSession(backend="sim", config=RefConfig(**cfg), encoding=encoding,
                     verify="off", **kw)
    port = ComputeSession(device="cpu", config=SSDConfig(**cfg),
                          encoding=encoding, **kw)
    return ref, port


def _write_and_build(sess, encoding, bits):
    """The same writes and expressions on either package's session."""
    a, b = sess.write_pair("a", bits[0], "b", bits[1])
    c = sess.write("c", bits[2])
    d = sess.write("d", bits[3])
    na, nb, nc, nd = (bits[i].astype(bool) for i in range(4))
    exprs = [
        ((a & b) | (c ^ d), (na & nb) | (nc ^ nd)),   # sense groups + combine
        (sess.chain("and", [a, b, c, d]), na & nb & nc & nd),   # fused chain
        (~c, ~nc),                                    # NOT (NOT-ready copy)
    ]
    if encoding == "tlc":
        x, y, z = sess.write_triple("x", bits[4], "y", bits[5], "z", bits[6])
        nx, ny, nz = (bits[i].astype(bool) for i in (4, 5, 6))
        exprs.append((x & y & z, nx & ny & nz))       # one-sense AND3
    else:
        exprs.append((a.xnor(b), ~(na ^ nb)))         # one inverse-read sense
    return exprs


def _unpacked(words: np.ndarray, n_bits: int) -> np.ndarray:
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    # lane-major layout: word w of a 4096-cell tile holds column k*128 + w
    tiles = bits.reshape(-1, 128, 32).transpose(0, 2, 1).reshape(-1)
    return tiles[:n_bits].astype(bool)


def test_session_matches_reference():
    for encoding in ("mlc", "tlc", "reduced-mlc"):
        for dies in (1, 2, 4):
            _check_session(encoding, dies)


def _check_session(encoding, dies):
    rng = np.random.default_rng(dies)
    bits = [(rng.random(N_BITS) < 0.5).astype(np.uint8) for _ in range(7)]
    ref, port = _sessions(encoding, dies)
    ref_exprs = _write_and_build(ref, encoding, bits)
    port_exprs = _write_and_build(port, encoding, bits)
    for (r_expr, want), (p_expr, _) in zip(ref_exprs, port_exprs):
        r_words = np.asarray(ref.materialize(r_expr))
        p_words = to_numpy(port.materialize(p_expr))
        assert p_words.dtype == np.uint32 and p_words.shape == r_words.shape
        np.testing.assert_array_equal(_unpacked(p_words, N_BITS), want)
        np.testing.assert_array_equal(_unpacked(r_words, N_BITS), want)
        assert port.popcount(p_expr) == ref.popcount(r_expr) == int(want.sum())
    r_stats, p_stats = ref.stats(), port.stats()
    for key in COUNTERS:
        assert p_stats[key] == r_stats[key], (encoding, dies, key)
    for key in ("misses", "hits", "traces"):
        assert p_stats["executor"][key] == r_stats["executor"][key], \
            (encoding, dies, key)
    assert p_stats["plan_cache"] == r_stats["plan_cache"]
    assert p_stats["arena_rows_by_encoding"] == r_stats["arena_rows_by_encoding"]
    assert port.ledger.makespan_us() == ref.ledger.makespan_us()
    assert port.ledger.summary() == ref.ledger.summary()

    # state carry-over: load the reference arena's rows into the port's
    port.device.load_vth({die: np.asarray(shard.buf)
                          for die, shard in ref.device.arena._shards.items()})
    for (r_expr, _), (p_expr, _) in zip(ref_exprs, port_exprs):
        np.testing.assert_array_equal(to_numpy(port.materialize(p_expr)),
                                      np.asarray(ref.materialize(r_expr)))


def test_loaded_arena_and_chain_split_match_reference():
    """A direct (non-inverse) XOR clamps below the DAC range and misreads
    many cells: after the load both packages misread the same ones.  A chain
    longer than one fused pass (32 operands) splits into the same passes as
    the reference's default VMEM budget gives."""
    ref, port = _sessions("mlc", 2)
    rng = np.random.default_rng(7)
    bits = [(rng.random(N_BITS) < 0.5).astype(np.uint8) for _ in range(2)]
    ref.write_pair("a", bits[0], "b", bits[1])
    port.write_pair("a", bits[0], "b", bits[1])
    r_wls, p_wls = ref.ftl.vectors["a"].pages, port.ftl.vectors["a"].pages
    assert r_wls == p_wls
    r_plan = ref.device.plans.get("xor", ref.chip, use_inverse_read=False)
    p_plan = port.device.plans.get("xor", port.chip, use_inverse_read=False)
    assert (r_plan.refs, r_plan.kind) == (p_plan.refs, p_plan.kind)
    r_words = np.asarray(ref.device.mcflash_read_batch(r_wls, "xor", plan=r_plan))
    before = to_numpy(port.device.mcflash_read_batch(p_wls, "xor", plan=p_plan))
    assert not np.array_equal(before, r_words)      # different noise draws
    port.device.load_vth({die: np.asarray(shard.buf)
                          for die, shard in ref.device.arena._shards.items()})
    np.testing.assert_array_equal(
        port.device.vth_stack(p_wls).numpy(),
        np.asarray(ref.device.vth_stack(r_wls)))
    after = to_numpy(port.device.mcflash_read_batch(p_wls, "xor", plan=p_plan))
    np.testing.assert_array_equal(after, r_words)
    ref.device.mcflash_read_batch(r_wls, "xor", plan=r_plan)
    assert port.ledger.summary() == ref.ledger.summary()

    rng = np.random.default_rng(3)
    n, n_ops = 8192, 66             # 33 paired ANDs: one operand too many
    bits = [(rng.random(n) < 0.99).astype(np.uint8) for _ in range(n_ops)]
    ref, port = _sessions("mlc", 2)
    for sess in (ref, port):
        for i in range(0, n_ops, 2):
            sess.write_pair(f"v{i}", bits[i], f"v{i + 1}", bits[i + 1])
    want = np.logical_and.reduce([b.astype(bool) for b in bits])
    r_expr = ref.chain("and", [f"v{i}" for i in range(n_ops)])
    p_expr = port.chain("and", [f"v{i}" for i in range(n_ops)])
    assert port.popcount(p_expr) == ref.popcount(r_expr) == int(want.sum())
    np.testing.assert_array_equal(
        port.materialize(p_expr, unpacked=True).numpy().astype(bool), want)
    np.testing.assert_array_equal(
        np.asarray(ref.materialize(r_expr, unpacked=True)).astype(bool), want)
    for key in COUNTERS:
        assert getattr(port, key) == getattr(ref, key), key
    assert port.plan_context().max_fused_operands == MAX_FUSED_OPERANDS == 32
    assert port.tiled_megakernel_splits == 2      # the count and the words


@settings(max_examples=8, deadline=None, database=None)
@given(st.integers(0, 2**31 - 1))
def test_randomized_dags_match_oracle(seed):
    """Random mixed DAGs over pairs and scattered vectors equal the numpy
    oracle, materialized and counted."""
    rng = np.random.default_rng(seed)
    n = 4096 + int(rng.integers(0, 4096))
    port = ComputeSession(device="cpu", config=SSDConfig(
        channels=1, dies_per_channel=2, page_kb=1), seed=seed % 1000)
    raw = [(rng.random(n) < 0.5).astype(np.uint8) for _ in range(4)]
    a, b = port.write_pair("a", raw[0], "b", raw[1])
    c, d = port.write("c", raw[2]), port.write("d", raw[3])
    leaves = [(a, raw[0].astype(bool)), (b, raw[1].astype(bool)),
              (c, raw[2].astype(bool)), (d, raw[3].astype(bool))]
    nodes = list(leaves)
    for _ in range(4):
        (x, vx), (y, vy) = (nodes[i] for i in rng.integers(0, len(nodes), 2))
        op = ["and", "or", "xor", "not"][int(rng.integers(0, 4))]
        if op == "not":
            nodes.append((~x, ~vx))
        elif op == "and":
            nodes.append((x & y, vx & vy))
        elif op == "or":
            nodes.append((x | y, vx | vy))
        else:
            nodes.append((x ^ y, vx ^ vy))
    expr, want = nodes[-1]
    np.testing.assert_array_equal(
        port.materialize(expr, unpacked=True).numpy().astype(bool), want)
    assert port.popcount(expr) == int(want.sum())


def test_port_boundaries():
    """Async drains return uint32 words; no card and no ``device="cpu"``
    raises; verification, faults, recovery and tracing take the JAX
    package's options; the port imports neither JAX nor the JAX package."""
    port = ComputeSession(device="cpu", config=SSDConfig(
        channels=1, dies_per_channel=2, page_kb=1), drain_depth=1)
    rng = np.random.default_rng(5)
    bits = [(rng.random(8192) < 0.5).astype(np.uint8) for _ in range(2)]
    a, b = port.write_pair("a", bits[0], "b", bits[1])
    h1 = port.materialize_async(a & b)
    port.materialize_async(a | b)
    assert h1.done                  # resolved by the depth-1 backpressure
    outs = port.drain()
    assert len(outs) == 1 and outs[0].dtype == np.uint32
    np.testing.assert_array_equal(_unpacked(h1.result(), 8192),
                                  (bits[0] & bits[1]).astype(bool))
    assert port.stats()["host_drain"] == {"submits": 2, "blocks": 1,
                                          "pending": 0, "depth": 1}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ComputeSession()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_session.resolve_device("cuda")
    opts = ComputeSession(device="cpu", verify="paranoid", faults="pe=5000",
                          recovery=True, trace=True)
    assert opts.verifier.mode == "paranoid" and opts.trace is not None
    assert opts.device.faults.cfg.pe == 5000 and opts.reliability is not None
    assert port.stats()["verify"]["mode"] == "on"     # the default
    assert port.stats()["plans_verified"] > 0

    # on the CPU the kernels' wrappers take their plain versions: no launch
    before = dict(cuda.launches)
    count = port.popcount(port.chain("xor", [a, b, ~a]) | (a & b))
    assert count == int((~bits[1].astype(bool) | (bits[0] & bits[1]).astype(bool)).sum())
    assert port.stats()["backend"] == "sim" and cuda.launches == before

    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), (path, mod)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
