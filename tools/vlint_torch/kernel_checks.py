"""The port's kernel checks, the twin of the reference's PK01 for
hand-written Hopper kernels: HK01 (where a kernel may live), HK02 (each
launching wrapper has a plain version and counts its launches) and HK03
(no fallback: a build or launch failure is never swallowed).

A launch is recognised by what every wrapper of the port passes its C
entry: the raw handle of the current stream, `stream_handle(dev)`; a
Triton launch is `kernel[grid](...)` on a `@triton.jit` function of the
module.
"""

from __future__ import annotations

import ast

from ..vlint.core import NativeFile, PyModule, Violation, dotted
from .checks import _docstring_ids, _parent_map

_LIB_LOADERS = ("CDLL", "PyDLL", "LoadLibrary", "ExtensionFileLoader")
# the package of the wrappers: whatever a module imports from it is a
# kernel entry for HK03
_KERNEL_PACKAGE = "kernels"
_NATIVE_KERNEL_EXT = (".cu", ".cuh")


def _triton_jitted(tree: ast.AST) -> set:
    """Names of the module's functions decorated with triton.jit (or a
    `jit` imported from triton)."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                d = dotted(dec.func if isinstance(dec, ast.Call) else dec)
                if d in ("triton.jit", "jit", "triton.autotune"):
                    out.add(node.name)
    return out


def _is_launch(call: ast.Call, jitted: set) -> bool:
    for a in list(call.args) + [kw.value for kw in call.keywords]:
        if isinstance(a, ast.Call):
            d = dotted(a.func)
            if d is not None and d.rsplit(".", 1)[-1] == "stream_handle":
                return True
    f = call.func
    return (isinstance(f, ast.Subscript) and isinstance(f.value, ast.Name)
            and f.value.id in jitted)


def _calls(node: ast.AST):
    return (n for n in ast.walk(node) if isinstance(n, ast.Call))


def _in_any(path: str, marks) -> bool:
    return any(m in path for m in marks)


# ------------------------------------------------------------------- HK01

def _variants_refs(mod: PyModule) -> list:
    """(line, what) of every reference that wires variants/ in: an
    import of a variants module, or a path string naming the folder."""
    docstrings = _docstring_ids(mod.tree)
    out = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom):
            parts = (node.module or "").split(".") + [
                a.name for a in node.names]
            if "variants" in parts:
                out.append((node.lineno, f"import of {node.module!r}"))
        elif isinstance(node, ast.Import):
            for a in node.names:
                if "variants" in a.name.split("."):
                    out.append((node.lineno, f"import of {a.name!r}"))
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docstrings:
            v = node.value.replace("\\", "/")
            if v == "variants" or "variants/" in v:
                out.append((node.lineno, f"path {node.value!r}"))
    return out


def _kernel_entries(mod: PyModule) -> list:
    """(line, what) of every kernel entry in a module: a Triton import or
    jit, a torch C++/CUDA extension build, a shared-library load, a
    kernel launch."""
    jitted = _triton_jitted(mod.tree)
    out = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] == "triton" or \
                        "cpp_extension" in a.name:
                    out.append((node.lineno, f"import of {a.name!r}"))
        elif isinstance(node, ast.ImportFrom):
            module = node.module or ""
            names = {a.name for a in node.names}
            if module.split(".")[0] == "triton" or \
                    "cpp_extension" in module or "cpp_extension" in names:
                out.append((node.lineno, f"import from {module!r}"))
        elif isinstance(node, ast.Call):
            d = dotted(node.func) or ""
            leaf = d.rsplit(".", 1)[-1]
            if leaf == "load_inline" or d.endswith("cpp_extension.load"):
                out.append((node.lineno, f"extension build {d}()"))
            elif leaf in _LIB_LOADERS and (
                    leaf == "ExtensionFileLoader" or d.startswith("ctypes.")
                    or d == leaf):
                out.append((node.lineno, f"library load {d}()"))
            elif _is_launch(node, jitted):
                out.append((node.lineno, "kernel launch"))
    return out


def check_hk01(mod: PyModule, ctx, config: dict) -> list:
    """Kernel containment. Outside kernels/ and csrc/, no Triton import
    or jit, no load_inline/cpp_extension build, no ctypes or extension
    library load and no launch of a C entry: every kernel is built,
    loaded and launched by its wrapper in kernels/. Anywhere, nothing
    wires variants/ in: its sources are experiments no main path
    builds."""
    out = []
    if not _in_any(mod.path, config["hk01_homes"]):
        for line, what in _kernel_entries(mod):
            out.append(Violation(
                mod.path, line, "HK01",
                f"{what} outside veneur_tpu_torch/kernels/ — hand-written "
                "kernels are built, loaded and launched only by their "
                "wrappers there (sources in csrc/); move it or suppress "
                "with a reason"))
    for line, what in _variants_refs(mod):
        out.append(Violation(
            mod.path, line, "HK01",
            f"{what} wires veneur_tpu_torch/variants/ in — variants are "
            "unwired kernel experiments no main path may build or import"))
    return out


def check_hk01_native(nf: NativeFile, config: dict) -> list:
    """A kernel source (.cu/.cuh, or `__global__` in any C/C++ file) may
    live only in csrc/ or kernels/, or unwired in variants/."""
    if _in_any(nf.path, tuple(config["hk01_homes"])
               + tuple(config["hk01_unwired"])):
        return []
    line = 1 if nf.path.endswith(_NATIVE_KERNEL_EXT) else next(
        (i for i, t in enumerate(nf.lines, start=1) if "__global__" in t),
        None)
    if line is None:
        return []
    return [Violation(
        nf.path, line, "HK01",
        "kernel source outside veneur_tpu_torch/csrc/ — sources live "
        "there (or unwired in variants/) and are built by "
        "kernels/_build.py")]


# ------------------------------------------------------------------- HK02

def _module_names(tree: ast.AST) -> set:
    """Names a module defines at its top level or imports."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                out.add((a.asname or a.name).split(".")[0])
    return out


def _plain_branches(fn: ast.AST, names: set) -> list:
    """The `if <x>.is_cpu:` statements of `fn` whose body returns a call
    of a named function the module defines or imports: the plain
    version a CPU tensor takes."""
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.If):
            continue
        if not any(isinstance(n, ast.Attribute) and n.attr == "is_cpu"
                   for n in ast.walk(node.test)):
            continue
        returns = (r for st in node.body for r in ast.walk(st)
                   if isinstance(r, ast.Return)
                   and isinstance(r.value, ast.Call))
        if any((dotted(r.value.func) or ".").split(".")[0] in names
               for r in returns):
            out.append(node)
    return out


def _within(node: ast.AST, branch: ast.If) -> bool:
    return any(node is n for st in branch.body for n in ast.walk(st))


def check_hk02(mod: PyModule, ctx, config: dict) -> list:
    """Wrapper discipline. A function that launches a kernel has a plain
    version beside it (an `if <tensor>.is_cpu:` branch, before the
    launch, returning a call of a function the module defines or
    imports) and calls count_launch after its launch. count_launch is
    called nowhere else: not where no launch is, not on the plain
    branch — chip_smoke reads those counts as launches."""
    jitted = _triton_jitted(mod.tree)
    parents = _parent_map(mod.tree)
    names = _module_names(mod.tree)
    fn_kinds = (ast.FunctionDef, ast.AsyncFunctionDef)

    def owner(node):
        cur = parents.get(node)
        while cur is not None and not isinstance(cur, fn_kinds):
            cur = parents.get(cur)
        return cur

    launches: dict = {}
    counts: list = []
    for call in _calls(mod.tree):
        if _is_launch(call, jitted):
            launches.setdefault(owner(call), []).append(call.lineno)
        d = dotted(call.func)
        if d is not None and d.rsplit(".", 1)[-1] == "count_launch":
            counts.append(call)
    out = []
    branches = {}
    for fn, lines in launches.items():
        name = getattr(fn, "name", "<module>")
        plain = [b for b in _plain_branches(fn, names)
                 if b.lineno < min(lines)] if fn is not None else []
        branches[fn] = plain
        if not plain:
            out.append(Violation(
                mod.path, fn.lineno if fn is not None else min(lines),
                "HK02",
                f"kernel wrapper `{name}` launches with no plain version "
                "beside it — give it an `if <tensor>.is_cpu:` branch, "
                "before the launch, returning the plain torch function"))
        if not any(owner(c) is fn and c.lineno > max(lines)
                   and not any(_within(c, b) for b in plain)
                   for c in counts):
            out.append(Violation(
                mod.path, max(lines), "HK02",
                f"kernel wrapper `{name}` launches without count_launch "
                "after the launch — chip_smoke proves the main path ran "
                "the kernel by these counts"))
    for c in counts:
        fn = owner(c)
        if fn not in launches:
            out.append(Violation(
                mod.path, c.lineno, "HK02",
                "count_launch where no kernel is launched — a count "
                "marks a launch of its wrapper's kernel and nothing "
                "else"))
        elif any(_within(c, b) for b in branches[fn]):
            out.append(Violation(
                mod.path, c.lineno, "HK02",
                "count_launch on the plain (CPU) branch — plain calls "
                "are not launches and count nothing"))
    return out


# ------------------------------------------------------------------- HK03

def _kernel_callees(mod: PyModule) -> set:
    """Names whose call builds, loads or launches a kernel: whatever the
    module imports from the kernels package, and its own functions that
    (transitively) call lib(), a _build entry or a launch."""
    pkg = _KERNEL_PACKAGE
    in_pkg = f"/{pkg}/" in mod.path
    out = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom):
            parts = (node.module or "").split(".")
            if pkg in parts or (in_pkg and node.level == 1
                                and node.module is None):
                out.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if pkg in a.name.split(".") and a.asname:
                    out.add(a.asname)
    jitted = _triton_jitted(mod.tree)
    fns = [n for n in ast.walk(mod.tree)
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    changed = True
    while changed:
        changed = False
        for fn in fns:
            if fn.name not in out and any(
                    _is_kernel_call(c, out, jitted) for c in _calls(fn)):
                out.add(fn.name)
                changed = True
    return out


def _is_kernel_call(call: ast.Call, callees: set, jitted: set) -> bool:
    """A call of a name in `callees` (an imported name, a module function
    or a method through self/cls), or a launch, lib(), a _build entry,
    load_inline or a `vt_*` C entry."""
    d = dotted(call.func) or ""
    root, leaf = d.split(".", 1)[0], d.rsplit(".", 1)[-1]
    return (_is_launch(call, jitted)
            or leaf in ("lib", "load_inline") or leaf.startswith("vt_")
            or d in ("_build.load", "_build.build")
            or root in callees
            or (root in ("self", "cls") and d.count(".") == 1
                and leaf in callees))


def check_hk03(mod: PyModule, ctx, config: dict) -> list:
    """No fallback: a `try` whose body builds, loads or launches a kernel
    (or calls a kernel wrapper) may not have a handler that swallows the
    failure — every handler re-raises. A card that cannot build or run
    a kernel fails loudly; it never serves the plain version instead."""
    callees = _kernel_callees(mod)
    jitted = _triton_jitted(mod.tree)
    out = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Try):
            continue
        if not any(_is_kernel_call(c, callees, jitted)
                   for st in node.body for c in _calls(st)):
            continue
        for h in node.handlers:
            if not any(isinstance(n, ast.Raise) for n in ast.walk(h)):
                out.append(Violation(
                    mod.path, h.lineno, "HK03",
                    "handler swallows a kernel build or launch failure — "
                    "the port has no fallback: re-raise (a card that "
                    "cannot run its kernel must fail, not serve the "
                    "plain version)"))
    return out


PY_CHECKS = {"HK01": check_hk01, "HK02": check_hk02, "HK03": check_hk03}
