"""The port's placed wave runner against its unplaced runner and the JAX
package's placed run.

``FlashDevice(shard_devices=["cpu"] * 4, device="cpu")`` maps the dies'
shards onto four CPU entries (on a card, ``["cuda"] * 4`` gives each entry
its own stream; ``tests/test_torch_cuda_lm.py`` runs that there).  The DAG
is a copy of ``tests/test_multidevice.py``'s ``_random_dag``: mixed-op
pairs over two dies under an OR fold, so the plan has several waves and
controller combines.  The JAX side runs in a subprocess with four forced
host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``), its
placed session on the ``sim`` backend, and prints its counters as JSON.
"""
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api.session import ComputeSession
from repro_torch.core import tlc
from repro_torch.flash.device import FlashDevice

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_OPS = ("and", "xor", "or")


def _random_dag(sess, rng, n_pairs: int, n_bits: int, tag: str):
    """Mixed-op pair DAG across 2 dies + an or-fold root, plus the numpy
    reference (``tests/test_multidevice.py:178``)."""
    expr = ref = None
    for i in range(n_pairs):
        a = rng.integers(0, 2, n_bits, dtype=np.uint8)
        b = rng.integers(0, 2, n_bits, dtype=np.uint8)
        va, vb = sess.write_pair(f"{tag}a{i}", a, f"{tag}b{i}", b, die=i % 2)
        op = _OPS[i % len(_OPS)]
        pair = va._binary(op, vb)
        pr = {"and": a & b, "xor": a ^ b, "or": a | b}[op]
        expr = pair if expr is None else expr._binary("or", pair)
        ref = pr if ref is None else ref | pr
    return expr, ref


def _placed(**kw) -> ComputeSession:
    return ComputeSession(flash=FlashDevice(shard_devices=["cpu"] * 4,
                                            device="cpu"), **kw)


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.delenv("REPRO_VERIFY", raising=False)
    monkeypatch.delenv("REPRO_FAULTS", raising=False)


def _die_chain(sess, rng, n_pairs: int, n_bits: int, die: int):
    """An AND chain of ``2 * n_pairs`` vectors on one die (one fused,
    die-local unit; past 32 operands, split into passes) and its oracle."""
    vecs, bits = [], []
    for i in range(n_pairs):
        a, b = (rng.integers(0, 2, n_bits, dtype=np.uint8) for _ in "ab")
        vecs.extend(sess.write_pair(f"c{die}a{i}", a, f"c{die}b{i}", b,
                                    die=die))
        bits.extend((a, b))
    return sess.chain("and", vecs), np.logical_and.reduce(bits)


def test_placed_words_equal_unplaced_and_oracle():
    """Under mlc, tlc and reduced-mlc the placed runner's words equal the
    unplaced runner's and the numpy oracle, die-local fused chains (the
    fused popcount on its shard's entry, a chain split into two passes)
    included; only the placed session counts placed unit dispatches."""
    n_bits, n_pairs = 3000, 6
    for encoding in tlc.ENCODINGS:
        placed = _placed(encoding=encoding, overlap=True)
        expr, ref = _random_dag(placed, np.random.default_rng(3), n_pairs,
                                n_bits, "p")
        out_p = placed.materialize(expr, unpacked=True).numpy()
        np.testing.assert_array_equal(out_p, ref)
        assert placed.placed_unit_dispatches > 0
        assert placed.popcount(expr) == int(ref.sum())
        for n, die in ((2, 3), (33, 1)):
            chain, want = _die_chain(placed, np.random.default_rng(n), n,
                                     n_bits, die)
            np.testing.assert_array_equal(
                placed.materialize(chain, unpacked=True).numpy(), want)
            assert placed.popcount(chain) == int(want.sum())
        assert placed.tiled_megakernel_splits > 0
        arena = placed.device.arena
        assert [arena.slot_of(d) for d in range(6)] == [0, 1, 2, 3, 0, 1]
        assert arena.compute_device() == torch.device("cpu")
        assert arena.shard_devices() == [torch.device("cpu")] * 3   # dies 0, 1, 3

        plain = ComputeSession(device="cpu", encoding=encoding)
        expr_u, _ = _random_dag(plain, np.random.default_rng(3), n_pairs,
                                n_bits, "u")
        out_u = plain.materialize(expr_u, unpacked=True).numpy()
        np.testing.assert_array_equal(out_p, out_u)
        assert plain.placed_unit_dispatches == 0
        assert plain.device.arena.slot_of(0) is None


def test_placed_cache_keys_disjoint_and_replay():
    """Placed and unplaced runners never share a cache entry (the layout
    ends the key), and a second DAG of the same shape replays the placed
    runner without a rebuild."""
    def run(sess, tag):
        expr, ref = _random_dag(sess, np.random.default_rng(7), 4, 2000, tag)
        np.testing.assert_array_equal(
            sess.materialize(expr, unpacked=True).numpy(), ref)
        return sess

    placed = run(_placed(), "x")
    plain = run(ComputeSession(device="cpu"), "x")
    placed_keys = set(placed.device.executables._entries)
    plain_keys = set(plain.device.executables._entries)
    assert placed_keys and plain_keys
    assert not placed_keys & plain_keys
    assert all(key[-1] is not None for key in placed_keys)
    assert all(key[-1] is None for key in plain_keys)
    layout = next(iter(placed_keys))[-1]
    assert {slot for _, slot in layout[0]} <= {0, 1}
    misses0, traces0 = placed.executor.cache.misses, placed.executor.traces
    run(placed, "y")
    assert placed.executor.cache.misses == misses0
    assert placed.executor.traces == traces0
    assert placed.executor.cache.hits > 0


_JAX_SIDE = r"""
import json
import numpy as np
from repro.api import ComputeSession
from repro.flash.device import FlashDevice
import jax
assert jax.device_count() == 4, jax.device_count()
out = {}
for mode in ("overlap", "sync"):
    sess = ComputeSession(FlashDevice(shard_devices="auto"), backend="sim",
                          overlap=mode, drain_depth=2)
    expr, ref = _random_dag(sess, np.random.default_rng(11), 8, 2000, "m")
    sess.materialize_async(expr)
    (words,) = sess.drain()
    again, _ = _random_dag(sess, np.random.default_rng(11), 8, 2000, "n")
    bits = np.asarray(sess.materialize(again, unpacked=True))
    out[mode] = {
        "placed_unit_dispatches": sess.placed_unit_dispatches,
        "sense_waves": sess.sense_waves, "sense_batches": sess.sense_batches,
        "misses": sess.executor.cache.misses,
        "hits": sess.executor.cache.hits,
        "makespan_us": sess.ledger.makespan_us(),
        "overlapped_channel_us": sess.ledger.overlapped_channel_us,
        "exact": bool(np.array_equal(bits, ref)), "words": int(words.size)}
print(json.dumps(out))
"""
#: the JAX side builds the same DAG with this file's own ``_random_dag``
_JAX_SIDE = (f"_OPS = {_OPS!r}\n" + inspect.getsource(_random_dag)
             + _JAX_SIDE)


def _port_side() -> dict:
    out = {}
    for mode in ("overlap", "sync"):
        sess = _placed(overlap=mode, drain_depth=2)
        expr, ref = _random_dag(sess, np.random.default_rng(11), 8, 2000, "m")
        sess.materialize_async(expr)
        (words,) = sess.drain()
        again, _ = _random_dag(sess, np.random.default_rng(11), 8, 2000, "n")
        bits = sess.materialize(again, unpacked=True).numpy()
        out[mode] = {
            "placed_unit_dispatches": sess.placed_unit_dispatches,
            "sense_waves": sess.sense_waves,
            "sense_batches": sess.sense_batches,
            "misses": sess.executor.cache.misses,
            "hits": sess.executor.cache.hits,
            "makespan_us": sess.ledger.makespan_us(),
            "overlapped_channel_us": sess.ledger.overlapped_channel_us,
            "exact": bool(np.array_equal(bits, ref)),
            "words": int(words.size)}
    return out


def test_placed_counters_match_jax_placed_run():
    """Counters and makespans of a placed run (overlap and sync ledgers,
    async drain, then a same-shape replay) equal the JAX package's placed
    run on four forced host devices."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("REPRO_VERIFY", "REPRO_FAULTS")}
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT), env.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _JAX_SIDE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    got = _port_side()
    assert got == want
    assert got["overlap"]["exact"] and got["overlap"]["placed_unit_dispatches"]
    assert got["overlap"]["makespan_us"] < got["sync"]["makespan_us"]
    assert got["overlap"]["sense_waves"] >= 3
