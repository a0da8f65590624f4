"""Repo-invariant linter for the PyTorch port: layering rules the type
system can't enforce.

AST-based, stdlib-only (no torch import), the JAX package's
``repro.verify.lint`` with its rules retargeted to torch:

- ``kernel-call-outside-kernels`` — the kernel entry points
  (``sense_plan``, ``sense_reduce_plan``, ``bitwise_reduce``, ...) may only
  be called from ``repro_torch/kernels/`` and the backend
  (``api/backends.py``).  Everything else goes through a
  :class:`~repro_torch.api.backends.Backend`, whose wrappers pick the CUDA
  kernel or its plain version by the tensor's device.
- ``host-sync-in-hot-path`` — no device->host syncs (``.cpu()``,
  ``.numpy()``, ``.item()``, ``.tolist()``, ``torch.cuda.synchronize()``)
  inside the executor/kernel hot paths; a hidden sync there stalls the
  launch stream.
- ``unledgered-transfer`` — no raw ``.cpu()`` / ``.to("cpu")`` in the
  device/session data path (``api/`` + ``flash/``): host transfers go
  through ``FlashDevice.ext_to_host`` so the ledger books them.  The
  arena is the one sanctioned exception.
- ``bare-plan-compile`` — the plan compilers (``plan_op`` /
  ``pattern_plan`` / ``plan_encoded``) may only be called by the caches in
  ``api/plan_cache.py`` (and the compilers themselves): a bare compile
  bypasses the encoding-keyed cache.

Suppress a finding with a same-line pragma, with a comment that says why::

    plan = mcflash.plan_op(op, chip)   # verify: allow(bare-plan-compile)

Run as ``python -m repro_torch.verify.lint src/repro_torch`` — exits
non-zero on findings, printing ``path:line:col rule message`` lines.
"""
from __future__ import annotations

import argparse
import ast
import re
import sys
from pathlib import Path
from typing import Iterator, List, NamedTuple, Optional, Tuple

__all__ = ["Violation", "lint_file", "lint_paths", "main"]

#: packing helpers on the kernels surface that any layer may use
#: (no kernel launch, no backend-parity concern)
KERNEL_HELPERS = frozenset({"pack_bits", "unpack_bits", "pad_rows",
                            "pad_refs"})
#: plan compilers that bypass the encoding-keyed caches when called bare
PLAN_COMPILERS = frozenset({"plan_op", "pattern_plan", "plan_encoded"})
#: tensor methods that copy to the host and wait for the device
HOST_SYNC_METHODS = frozenset({"cpu", "numpy", "item", "tolist"})
KERNELS_PACKAGE = "repro_torch.kernels"

_PRAGMA = re.compile(r"#\s*verify:\s*allow\(([a-z-]+)\)")


def _norm(path: str) -> str:
    return str(path).replace("\\", "/")


def _kernel_call_allowed(path: str) -> bool:
    return "/kernels/" in path or path.endswith("api/backends.py")


def _hot_path(path: str) -> bool:
    return ("/kernels/" in path or path.endswith("api/executor.py")
            or path.endswith("api/backends.py"))


def _data_path(path: str) -> bool:
    if path.endswith("flash/arena.py"):    # loads rows, not host DMA
        return False
    return "/api/" in path or "/flash/" in path


def _plan_compile_allowed(path: str) -> bool:
    return (path.endswith("core/mcflash.py") or path.endswith("core/tlc.py")
            or path.endswith("api/plan_cache.py"))


class Violation(NamedTuple):
    path: str
    line: int
    col: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col} {self.rule} {self.message}"


def _call_name(func: ast.expr) -> Tuple[Optional[str], Optional[str]]:
    """(base, attr) of a call target: ``kops.sense_plan`` -> ("kops",
    "sense_plan"); bare ``sense_plan`` -> (None, "sense_plan")."""
    if isinstance(func, ast.Attribute):
        base = func.value.id if isinstance(func.value, ast.Name) else None
        return base, func.attr
    if isinstance(func, ast.Name):
        return None, func.id
    return None, None


def _dotted(func: ast.expr) -> str:
    """``torch.cuda.synchronize`` for that attribute chain, else ''."""
    parts = []
    while isinstance(func, ast.Attribute):
        parts.append(func.attr)
        func = func.value
    if isinstance(func, ast.Name):
        parts.append(func.id)
        return ".".join(reversed(parts))
    return ""


def _is_cpu(node: ast.expr) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call) and _dotted(node.func) == "torch.device"
            and len(node.args) == 1 and _is_cpu(node.args[0]))


def _to_host(node: ast.Call) -> Optional[str]:
    """``.cpu()`` or ``.to("cpu")`` (positional or ``device=``) -> its
    rendering, else None."""
    if not isinstance(node.func, ast.Attribute):
        return None
    if node.func.attr == "cpu":
        return ".cpu()"
    if node.func.attr == "to":
        args = list(node.args[:1]) + [k.value for k in node.keywords
                                      if k.arg == "device"]
        if any(_is_cpu(a) for a in args):
            return '.to("cpu")'
    return None


def _check_call(path: str, node: ast.Call) -> Iterator[Violation]:
    base, name = _call_name(node.func)
    if name is None:
        return
    if _hot_path(path):
        sync = None
        if isinstance(node.func, ast.Attribute) and name in HOST_SYNC_METHODS:
            sync = f".{name}()"
        elif _dotted(node.func) in ("torch.cuda.synchronize",
                                    "cuda.synchronize"):
            sync = "torch.cuda.synchronize()"
        if sync is not None:
            yield Violation(
                path, node.lineno, node.col_offset, "host-sync-in-hot-path",
                f"{sync} forces a device->host sync inside the "
                "executor/kernel hot path")
    transfer = _to_host(node)
    if transfer is not None and _data_path(path):
        yield Violation(
            path, node.lineno, node.col_offset, "unledgered-transfer",
            f"raw {transfer} in the device data path bypasses the ledger —"
            " host transfers go through FlashDevice.ext_to_host")
    if name in PLAN_COMPILERS and not _plan_compile_allowed(path):
        yield Violation(
            path, node.lineno, node.col_offset, "bare-plan-compile",
            f"bare {name}() bypasses the encoding-keyed PlanCache — use"
            " session.plan() / PlanCache.get(_encoded)")


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, source_lines: List[str]):
        self.path = path
        self.lines = source_lines
        self.violations: List[Violation] = []
        # names defined in this module shadow same-named plan compilers etc.
        self.local_defs: set = set()
        #: local aliases bound to repro_torch.kernels submodules
        #: (``from repro_torch.kernels import ops as kops`` -> "kops")
        self.kernel_aliases: set = set()
        #: names imported *from* repro_torch.kernels modules (minus helpers)
        self.kernel_names: set = set()

    def collect_defs(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.local_defs.add(node.name)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if (alias.name == KERNELS_PACKAGE
                            or alias.name.startswith(KERNELS_PACKAGE + ".")):
                        self.kernel_aliases.add(
                            alias.asname or alias.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if mod == KERNELS_PACKAGE:
                    # submodule imports: from repro_torch.kernels import ops
                    for alias in node.names:
                        self.kernel_aliases.add(alias.asname or alias.name)
                elif mod.startswith(KERNELS_PACKAGE + "."):
                    # direct imports: from repro_torch.kernels.ops import x
                    for alias in node.names:
                        if alias.name not in KERNEL_HELPERS:
                            self.kernel_names.add(alias.asname or alias.name)

    def _allowed(self, line: int, rule: str) -> bool:
        if not 1 <= line <= len(self.lines):
            return False
        return rule in _PRAGMA.findall(self.lines[line - 1])

    def _kernel_violation(self, node: ast.Call) -> Optional[Violation]:
        if _kernel_call_allowed(self.path):
            return None
        base, name = _call_name(node.func)
        hit = ((base in self.kernel_aliases and name not in KERNEL_HELPERS)
               or (base is None and name in self.kernel_names
                   and name not in self.local_defs))
        if not hit:
            return None
        target = f"{base}.{name}" if base else name
        return Violation(
            self.path, node.lineno, node.col_offset,
            "kernel-call-outside-kernels",
            f"kernel call {target}() outside repro_torch/kernels/ and"
            " api/backends.py — go through the Backend")

    def visit_Call(self, node: ast.Call) -> None:
        base, name = _call_name(node.func)
        found = []
        kv = self._kernel_violation(node)
        if kv is not None:
            found.append(kv)
        if not (base is None and name in self.local_defs):
            found.extend(_check_call(self.path, node))
        for v in found:
            if not self._allowed(v.line, v.rule):
                self.violations.append(v)
        self.generic_visit(node)


def lint_file(path: "str | Path") -> List[Violation]:
    """Lint one Python source file; returns its violations."""
    p = Path(path)
    source = p.read_text()
    norm = _norm(str(p))
    try:
        tree = ast.parse(source, filename=str(p))
    except SyntaxError as exc:
        return [Violation(norm, exc.lineno or 1, exc.offset or 0,
                          "syntax-error", str(exc.msg))]
    visitor = _Visitor(norm, source.splitlines())
    visitor.collect_defs(tree)
    visitor.visit(tree)
    return visitor.violations


def lint_paths(paths: "List[str | Path]") -> List[Violation]:
    """Lint files / directory trees (``*.py``, sorted for stable output)."""
    files: List[Path] = []
    for p in map(Path, paths):
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        else:
            files.append(p)
    out: List[Violation] = []
    for f in files:
        out.extend(lint_file(f))
    return out


def main(argv: "List[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.verify.lint",
        description="repo-invariant linter for the PyTorch port")
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    args = ap.parse_args(argv)
    violations = lint_paths(args.paths)
    for v in violations:
        print(v.render())
    if violations:
        print(f"{len(violations)} violation(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
