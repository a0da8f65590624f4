"""The port's repo linter (``repro_torch.verify.lint``) against the JAX
package's (``repro.verify.lint``): every fixture case of
``tests/test_lint.py``, written once with the JAX names and once with the
torch names, is rejected by the same rule at the same line (or passes) in
both; the torch-only spellings of a host sync or transfer are caught; and
``src/repro_torch`` lints clean under both linters."""
import os
import subprocess
import sys
from pathlib import Path

import torch

from repro.verify import lint as ref_lint
from repro_torch.verify import lint

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"

#: (path under the package, JAX source, torch source, expected rules)
CASES = [
    ("checkpoint/thing.py",
     "from repro.kernels import ops as kops\n"
     "out = kops.bitwise_reduce(stack, op='xor')\n",
     "from repro_torch.kernels import ops as kops\n"
     "out = kops.bitwise_reduce(stack, op='xor')\n",
     ["kernel-call-outside-kernels"]),
    ("serve/other.py",
     "from repro.kernels.ops import sense_plan\nout = sense_plan(vth, plan)\n",
     "from repro_torch.kernels.ops import sense_plan\n"
     "out = sense_plan(vth, plan)\n",
     ["kernel-call-outside-kernels"]),
    ("api/session_like.py",
     "from repro.kernels import ops as kops\n"
     "words = kops.pack_bits(bits)\nbits = kops.unpack_bits(words)\n",
     "from repro_torch.kernels import ref as kops\n"
     "words = kops.pack_bits(bits)\nbits = kops.unpack_bits(words)\n", []),
    ("kernels/fused_like.py",
     "from repro.kernels import ops as kops\n"
     "out = kops.bitwise_reduce(stack, op='xor')\n",
     "from repro_torch.kernels import ops as kops\n"
     "out = kops.bitwise_reduce(stack, op='xor')\n", []),
    ("api/backends.py",
     "from repro.kernels import ops as kops\nout = kops.sense_plan(vth, plan)\n",
     "from repro_torch.kernels import ops as kops\n"
     "out = kops.sense_plan(vth, plan)\n", []),
    ("api/executor.py",
     "out = backend.sense_reduce(vth, plan, op='and')\n",
     "out = backend.sense_reduce(vth, plan, op='and')\n", []),
    # a sync on the api/ hot path that is also a host transfer: both rules
    ("api/executor.py",
     "import jax\nimport numpy as np\nx = jax.device_get(y)\n"
     "z = y.block_until_ready()\nw = np.asarray(y)\n",
     "import torch\nimport numpy as np\nx = y.cpu()\n"
     "z = torch.cuda.synchronize()\nw = y.numpy()\n",
     ["host-sync-in-hot-path"] * 3 + ["unledgered-transfer"]),
    ("obs/report.py",
     "import jax\nimport numpy as np\nx = jax.device_get(y)\n"
     "z = y.block_until_ready()\nw = np.asarray(y)\n",
     "import torch\nimport numpy as np\nx = y.cpu()\n"
     "z = torch.cuda.synchronize()\nw = y.numpy()\n", []),
    ("flash/ftl.py", "import jax\nx = jax.device_put(buf, dev)\n",
     "import torch\nx = buf.to('cpu')\n", ["unledgered-transfer"]),
    ("flash/arena.py", "import jax\nx = jax.device_put(buf, dev)\n",
     "import torch\nx = buf.to('cpu')\n", []),
    ("checkpoint/ckpt.py", "import jax\nx = jax.device_put(buf, dev)\n",
     "import torch\nx = buf.to('cpu')\n", []),
    ("serve/engine.py",
     "from repro.core import mcflash\nplan = mcflash.plan_op(op, chip)\n",
     "from repro_torch.core import mcflash\n"
     "plan = mcflash.plan_op(op, chip)\n", ["bare-plan-compile"]),
    ("serve/engine.py",
     "from repro.core import mcflash\nplan = mcflash.plan_op(op, chip)"
     "   # verify: allow(bare-plan-compile)\n",
     "from repro_torch.core import mcflash\nplan = mcflash.plan_op(op, chip)"
     "   # verify: allow(bare-plan-compile)\n", []),
    ("api/plan_cache.py", "plan = plan_op(op, chip)\n",
     "plan = plan_op(op, chip)\n", []),
    ("core/tlc.py", "plan = pattern_plan(label, pattern, chip, enc)\n",
     "plan = pattern_plan(label, pattern, chip, enc)\n", []),
    ("serve/engine.py",
     "def plan_op(op, chip):\n    return None\nplan = plan_op(op, chip)\n",
     "def plan_op(op, chip):\n    return None\nplan = plan_op(op, chip)\n", []),
    ("broken.py", "def f(:\n", "def f(:\n", ["syntax-error"]),
]


def _lint(module, root, rel, source):
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(source)
    return module.lint_file(p)


def test_fixture_cases_rejected_by_the_same_rule(tmp_path):
    for i, (rel, jax_src, torch_src, rules) in enumerate(CASES):
        want = _lint(ref_lint, tmp_path / f"j{i}" / "repro", rel, jax_src)
        got = _lint(lint, tmp_path / f"t{i}" / "repro_torch", rel, torch_src)
        assert sorted(v.rule for v in want) == sorted(rules), rel
        assert sorted(v.rule for v in got) == sorted(rules), (rel, got)
        assert sorted((v.rule, v.line) for v in got) == \
            sorted((v.rule, v.line) for v in want), rel
    [v] = _lint(lint, tmp_path / "msg" / "repro_torch", "flash/ftl.py",
                "x = buf.cpu()\n")
    assert v.rule == "unledgered-transfer" and "ext_to_host" in v.message


#: (path under the package, torch-only spelling, expected rules)
TORCH_CASES = [
    ("kernels/popcount.py", "n = int(c.item())\nrows = c.tolist()\n",
     ["host-sync-in-hot-path"] * 2),
    ("api/backends.py", "import torch\ntorch.cuda.synchronize()\n",
     ["host-sync-in-hot-path"]),
    ("api/hostio.py",
     "a = t.to(device='cpu')\nb = t.to(torch.device('cpu'))\n"
     "c = t.to('cuda')\nd = t.to(torch.int32)\n",
     ["unledgered-transfer"] * 2),
    ("flash/device.py",
     "x = rows.cpu()   # verify: allow(unledgered-transfer)\n", []),
]


def test_torch_spellings(tmp_path):
    """``.item()`` / ``.tolist()`` / ``torch.cuda.synchronize()`` on the
    hot path, and ``.to()`` towards the CPU in any spelling, in the data
    path; a device move or a cast is no transfer; the pragma holds."""
    for i, (rel, source, rules) in enumerate(TORCH_CASES):
        got = _lint(lint, tmp_path / str(i) / "repro_torch", rel, source)
        assert sorted(v.rule for v in got) == rules, rel


def test_walk_exit_codes_and_clean_tree(tmp_path, capsys):
    """``lint_paths`` walks directories, ``main`` exits 1 with a
    ``path:line:col rule`` line on a finding and 0 on a clean file, and
    ``python -m repro_torch.verify.lint src/repro_torch`` exits 0; the
    port's source lints clean under both linters."""
    _lint(lint, tmp_path / "walk", "repro_torch/api/a.py", "x = y.cpu()\n")
    _lint(lint, tmp_path / "walk", "repro_torch/api/b.py", "y = 1\n")
    vs = lint.lint_paths([tmp_path / "walk"])
    assert len(vs) == 1 and vs[0].rule == "unledgered-transfer"
    bad = tmp_path / "repro_torch" / "flash" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import torch\nx.cpu()\n")
    assert lint.main([str(bad)]) == 1
    out = capsys.readouterr().out
    assert "unledgered-transfer" in out and ":2:" in out
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert lint.main([str(good)]) == 0
    assert lint.lint_paths([SRC / "repro_torch"]) == []
    assert ref_lint.lint_paths([SRC / "repro_torch"]) == []
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.verify.lint",
         str(SRC / "repro_torch")],
        capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(SRC)})
    assert proc.returncode == 0, proc.stdout + proc.stderr
