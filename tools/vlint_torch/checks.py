"""The generic checks over the port: TH01, CF01, RS01, SR02, DR01, DR02,
TL01, TR01, WC01, OV01, SK01, DS01, QT01.

Each is the reference checker's (tools/vlint/py_checks.py) with the same
semantics, retargeted at the port's modules: run_paths applies each
check's scope and home-module allowances (config.py), so a check here
sees only the modules it governs. CF01 gains a second leg, the keys of
the port's `Config` that reach no consumer. Like the reference, every
check resolves only what is statically certain and stays silent where
it cannot prove a binding: a zero-false-positive gate, not inference.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from ..vlint.core import PyModule, Project, Violation, dotted, param_names


@dataclass
class Context:
    """Cross-module facts, built once per run."""
    # function name -> parameter names (self/cls stripped); first wins
    signatures: dict = field(default_factory=dict)
    # CF01 leg (b): (path, key, line) of every Config key with no
    # consumer outside its module
    dead_config_keys: list = field(default_factory=list)


def build_context(proj: Project, config: dict) -> Context:
    ctx = Context()
    for mod in proj.py_modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                params = param_names(node)
                if params and params[0] in ("self", "cls"):
                    params = params[1:]
                ctx.signatures.setdefault(node.name, tuple(params))
    ctx.dead_config_keys = _cf01_dead_keys(proj, config)
    return ctx


def _parent_map(tree: ast.AST) -> dict:
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def _docstring_ids(tree: ast.AST) -> set:
    """ids of the Constant nodes that are docstrings (the first statement
    of a module, class or def): literal-scanning checks exempt them."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant) and isinstance(
                    body[0].value.value, str):
                out.add(id(body[0].value))
    return out


def _dedupe(vs: list) -> list:
    seen, out = set(), []
    for v in vs:
        k = (v.line, v.message)
        if k not in seen:
            seen.add(k)
            out.append(v)
    return out


# ------------------------------------------------------------------- TH01

def _lockish(expr: ast.AST) -> bool:
    d = dotted(expr)
    if d is None and isinstance(expr, ast.Call):
        d = dotted(expr.func)
    return bool(d) and "lock" in d.lower()


def check_th01(mod: PyModule, ctx: Context, config: dict) -> list:
    """Unguarded shared-state writes: in the threaded files, a method
    reachable from two or more thread roots (Thread targets and public
    entry points, over the intra-class call graph) must hold a lock
    around writes to self.* state. Methods named *_locked run under the
    caller's lock by convention."""
    out = []
    suffixes = tuple(config["th01_locked_suffixes"])
    for cls in ast.walk(mod.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        methods = {n.name: n for n in cls.body
                   if isinstance(n, ast.FunctionDef)}
        edges: dict = {m: set() for m in methods}
        targets = set()
        for mname, fn in methods.items():
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                d = dotted(node.func)
                if d and d.startswith("self.") and \
                        d.count(".") == 1 and d[5:] in methods:
                    edges[mname].add(d[5:])
                if d and d.rsplit(".", 1)[-1] == "Thread":
                    for kw in node.keywords:
                        if kw.arg == "target":
                            td = dotted(kw.value)
                            if td and td.startswith("self.") \
                                    and td[5:] in methods:
                                targets.add(td[5:])
        targets |= _th01_spawned(methods)
        roots = targets | {m for m in methods if not m.startswith("_")}
        reached_by: dict = {m: set() for m in methods}
        for root in roots:
            stack, seen = [root], set()
            while stack:
                cur = stack.pop()
                if cur in seen:
                    continue
                seen.add(cur)
                reached_by[cur].add(root)
                stack.extend(edges.get(cur, ()))
        for mname, fn in methods.items():
            if mname == "__init__" or mname.endswith(suffixes):
                continue
            if len(reached_by[mname]) < 2:
                continue
            out.extend(_th01_writes(mod.path, mname, fn))
    return out


def _th01_spawned(methods: dict) -> set:
    """Methods started on a thread through a spawner: a method of the
    class that passes one of its parameters as a Thread's target (the
    port's `self._spawn(self._flush_loop, "flusher")`). The reference's
    servers name the target in the Thread call itself."""
    spawners = {}   # spawner name -> (index, name) of its target param
    for mname, fn in methods.items():
        params = param_names(fn)[1:]
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call) and (dotted(node.func) or "")
                    .rsplit(".", 1)[-1] == "Thread"):
                continue
            for kw in node.keywords:
                if kw.arg == "target" and isinstance(kw.value, ast.Name) \
                        and kw.value.id in params:
                    spawners[mname] = (params.index(kw.value.id),
                                       kw.value.id)
    out = set()
    for fn in methods.values():
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if not (d and d.startswith("self.") and d[5:] in spawners):
                continue
            i, name = spawners[d[5:]]
            args = list(node.args[i:i + 1]) + [
                kw.value for kw in node.keywords if kw.arg == name]
            for a in args:
                td = dotted(a)
                if td and td.startswith("self.") and td[5:] in methods:
                    out.add(td[5:])
    return out


def _th01_writes(path: str, mname: str, fn: ast.FunctionDef) -> list:
    out = []

    def self_attr_of(t):
        """self.X or self.X[...] target -> attribute name X."""
        if isinstance(t, ast.Subscript):
            t = t.value
        if isinstance(t, ast.Attribute) and \
                isinstance(t.value, ast.Name) and t.value.id == "self":
            return t.attr
        return None

    def visit(node, locked):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            locked = locked or any(_lockish(item.context_expr)
                                   for item in node.items)
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                attr = self_attr_of(t)
                if attr is not None and not locked:
                    out.append(Violation(
                        path, node.lineno, "TH01",
                        f"write to self.{attr} in `{mname}` — the "
                        "method is reachable from multiple threads "
                        "and the write is not under a lock"))
        for child in ast.iter_child_nodes(node):
            visit(child, locked)

    visit(fn, False)
    return out


# ------------------------------------------------------------------- CF01

def _cfg_fields(expr: ast.AST) -> set:
    """cfg field names an expression reads: cfg.X / self.cfg.X /
    anything.cfg.X."""
    out = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute):
            base = dotted(node.value)
            if base is not None and (base == "cfg"
                                     or base.endswith(".cfg")):
                out.add(node.attr)
    return out


def _cf01_dead_keys(proj: Project, config: dict) -> list:
    """Leg (b): every key of a config module's `Config` dataclass must
    reach a consumer. A key is consumed when a module other than its
    own names it (an attribute, or a string for getattr), or when a
    `Config` method or property reads `self.<key>` and another module
    names that method. Reads inside the config module alone (its
    validation and coercion) consume nothing."""
    homes = tuple(config["cf01_config_modules"])
    out = []
    for mod in proj.py_modules:
        if not any(h in mod.path for h in homes):
            continue
        names = set()
        for other in proj.py_modules:
            if other is mod:
                continue
            for n in ast.walk(other.tree):
                if isinstance(n, ast.Attribute):
                    names.add(n.attr)
                elif isinstance(n, ast.Constant) and isinstance(n.value,
                                                                str):
                    names.add(n.value)
        for cls in mod.tree.body:
            if not (isinstance(cls, ast.ClassDef) and cls.name == "Config"):
                continue
            reads_via = {}   # key -> Config methods reading self.<key>
            for m in cls.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    for n in ast.walk(m):
                        if isinstance(n, ast.Attribute) and isinstance(
                                n.value, ast.Name) and n.value.id == "self":
                            reads_via.setdefault(n.attr, set()).add(m.name)
            for st in cls.body:
                if not (isinstance(st, ast.AnnAssign)
                        and isinstance(st.target, ast.Name)):
                    continue
                key = st.target.id
                if key in names or reads_via.get(key, set()) & names:
                    continue
                out.append((mod.path, key, st.lineno))
    return out


def check_cf01(mod: PyModule, ctx: Context, config: dict) -> list:
    """Config-plumbing parity. (a) Within a sibling family (same
    receiver, same method-name prefix), a cfg-derived value passed for
    parameter P at one call site must be passed at every sibling whose
    signature also accepts P (the class of the start_ssf_udp rcvbuf
    bug). (b) Every key of the port's `Config` reaches a consumer
    outside config.py."""
    prefixes = tuple(config["cf01_prefixes"])
    groups: dict = {}
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or \
                not isinstance(node.func, ast.Attribute):
            continue
        recv = dotted(node.func.value)
        mname = node.func.attr
        if recv is None or mname.split("_")[0] not in prefixes:
            continue
        groups.setdefault((recv, mname.split("_")[0]), []).append(node)

    out = []
    for (recv, _prefix), calls in groups.items():
        if len(calls) < 2:
            continue
        bound = []   # (call, mname, params, explicit, {param: fields})
        for call in calls:
            mname = call.func.attr
            sig = ctx.signatures.get(mname)
            if sig is None:
                continue
            params = list(sig)
            binding: dict = {}
            for i, a in enumerate(call.args):
                if i < len(params):
                    f = _cfg_fields(a)
                    if f:
                        binding[params[i]] = f
            explicit = {params[i] for i in range(min(len(call.args),
                                                     len(params)))}
            for kw in call.keywords:
                if kw.arg is not None:
                    explicit.add(kw.arg)
                    f = _cfg_fields(kw.value)
                    if f:
                        binding[kw.arg] = f
            bound.append((call, mname, params, explicit, binding))
        for (ca, na, _pa, _ea, ba) in bound:
            for param, fields in ba.items():
                for (cb, nb, pb, eb, _bb) in bound:
                    if cb is ca or param not in pb or param in eb:
                        continue
                    fld = ",".join(sorted(fields))
                    out.append(Violation(
                        mod.path, cb.lineno, "CF01",
                        f"sibling `{recv}.{na}` passes cfg.{fld} as "
                        f"`{param}` but `{nb}` leaves it at its "
                        "default — config plumbing must reach every "
                        "sibling listener"))
    for path, key, line in ctx.dead_config_keys:
        if path == mod.path:
            out.append(Violation(
                mod.path, line, "CF01",
                f"config key `{key}` reaches no consumer: no module but "
                "config.py reads it, directly or through a Config "
                "property — plumb it through or drop the key"))
    return _dedupe(out)


# ------------------------------------------------------------------- RS01

_RS01_GRPC_LEAVES = ("insecure_channel", "secure_channel")


def check_rs01(mod: PyModule, ctx: Context, config: dict) -> list:
    """Raw egress bypassing the resilience layer: a direct urlopen call
    or grpc channel construction outside resilience.py skips the
    retry/backoff, circuit-breaker and deadline-budget treatment every
    egress must receive. Route HTTP through Egress.post/fetch and
    channels through resilience.grpc_channel."""
    out = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        d = dotted(node.func)
        if d is None:
            continue
        leaf = d.rsplit(".", 1)[-1]
        if leaf == "urlopen":
            out.append(Violation(
                mod.path, node.lineno, "RS01",
                "raw urlopen() bypasses the egress-resilience layer "
                "(no retry/backoff, no circuit breaker, no deadline "
                "budget) — route through resilience.Egress.post/fetch "
                "or suppress with a reason"))
        elif leaf in _RS01_GRPC_LEAVES and (d == leaf
                                            or d.startswith("grpc.")):
            out.append(Violation(
                mod.path, node.lineno, "RS01",
                f"raw {leaf}() bypasses the egress-resilience layer — "
                "create channels via resilience.grpc_channel (and wrap "
                "calls in Egress.call) or suppress with a reason"))
    return out


# ------------------------------------------------------------------- SR02

_SR02_FIELDS = ("mean", "weight")


def check_sr02(mod: PyModule, ctx: Context, config: dict) -> list:
    """Sorted-prefix protection: TDigestBank.mean/weight rows stay as
    ops/tdigest.py's cluster core (or the compress kernel, bit for bit
    its twin) emits them; the merge-path compress needs their order.
    Flagged: `TDigestBank(...)` binding those fields (positionally, by
    keyword or through an opaque **kwargs) and `._replace` with them."""
    out = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        d = dotted(node.func)
        if d is not None and d.rsplit(".", 1)[-1] == "TDigestBank":
            binds = node.args or any(
                kw.arg is None or kw.arg in _SR02_FIELDS
                for kw in node.keywords)
            if binds:
                out.append(Violation(
                    mod.path, node.lineno, "SR02",
                    "TDigestBank construction outside ops/tdigest.py "
                    "writes mean/weight — the merge-path compress "
                    "REQUIRES cluster order on those rows; build banks "
                    "through the ops module or suppress with a reason "
                    "proving the order holds"))
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr == "_replace":
            fields = sorted(kw.arg for kw in node.keywords
                            if kw.arg in _SR02_FIELDS)
            if not fields and any(kw.arg is None for kw in node.keywords):
                fields = ["**"]
            if fields:
                out.append(Violation(
                    mod.path, node.lineno, "SR02",
                    f"._replace({', '.join(fields)}=...) outside "
                    "ops/tdigest.py rewrites t-digest centroid rows — "
                    "the merge-path compress requires their cluster "
                    "order; route the write through ops/tdigest.py or "
                    "suppress with a reason proving the order holds"))
    return out


# ------------------------------------------------------------------- DR01

_DR01_WRITE_MODE_CHARS = set("wax+")
_DR01_PATH_WRITERS = ("write_bytes", "write_text")
_DR01_WRITE_FLAGS = {"O_WRONLY", "O_RDWR", "O_CREAT", "O_APPEND", "O_TRUNC",
                     "O_EXCL", "O_TMPFILE"}
_OPAQUE = object()


def _open_mode(call: ast.Call):
    """open()'s mode: its literal, None when omitted (read-only), or
    _OPAQUE when not statically resolvable (flagged: a gate must not be
    dodgeable by spelling)."""
    node = call.args[1] if len(call.args) >= 2 else None
    for kw in call.keywords:
        if kw.arg == "mode":
            node = kw.value
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return _OPAQUE


def check_dr01(mod: PyModule, ctx: Context, config: dict) -> list:
    """Durable-state write discipline: inside the durability package,
    every on-disk mutation goes through durability/journal.py, which
    owns the CRC32C framing, the fsync policy and the atomic rename.
    Flagged: open() with a write (or opaque) mode, os.open with write
    (or opaque) flags, os.write, Path.write_bytes/write_text."""
    out = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        d = dotted(node.func)
        leaf = (d.rsplit(".", 1)[-1] if d is not None
                else getattr(node.func, "attr", None))
        if d in ("open", "io.open", "builtins.open"):
            mode = _open_mode(node)
            if mode is _OPAQUE or (isinstance(mode, str) and (
                    _DR01_WRITE_MODE_CHARS & set(mode))):
                shown = "<unresolvable>" if mode is _OPAQUE else repr(mode)
                out.append(Violation(
                    mod.path, node.lineno, "DR01",
                    f"open(..., {shown}) writes durable state outside "
                    "the journal/snapshot API — route the bytes through "
                    "Journal.append/snapshot (CRC32C framing, fsync "
                    "policy, atomic rename) or suppress with a reason"))
        elif d == "os.open":
            flags_node = None
            if len(node.args) >= 2:
                flags_node = node.args[1]
            else:
                for kw in node.keywords:
                    if kw.arg == "flags":
                        flags_node = kw.value
            names = {n.attr for n in ast.walk(flags_node)
                     if isinstance(n, ast.Attribute)} \
                if flags_node is not None else set()
            readonly = names and not (names & _DR01_WRITE_FLAGS) and all(
                n.startswith("O_") for n in names)
            if not readonly:
                out.append(Violation(
                    mod.path, node.lineno, "DR01",
                    "os.open() with write-capable (or unresolvable) "
                    "flags under the durability package bypasses the "
                    "journal/snapshot API's framing and fsync "
                    "discipline — use Journal.append/snapshot or "
                    "suppress with a reason"))
        elif d == "os.write":
            out.append(Violation(
                mod.path, node.lineno, "DR01",
                "os.write() under the durability package writes "
                "unframed bytes the recovery scan cannot validate — "
                "use Journal.append/snapshot or suppress with a reason"))
        elif leaf in _DR01_PATH_WRITERS and isinstance(
                node.func, ast.Attribute):
            out.append(Violation(
                mod.path, node.lineno, "DR01",
                f".{leaf}() under the durability package bypasses the "
                "journal/snapshot API — use Journal.append/snapshot or "
                "suppress with a reason"))
    return out


# ------------------------------------------------------------------- DR02

def check_dr02(mod: PyModule, ctx: Context, config: dict) -> list:
    """Engine-state serialization discipline: within the engine, ops,
    cluster and durability layers, raw byte moves (`<arr>.tobytes()`,
    `<np|torch>.frombuffer(...)`) are single-homed in
    durability/records.py, whose codecs keep the checkpoint's
    kill-restart bit identity. Non-bank byte moves suppress with a
    reason naming what bytes they are."""
    out = []
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        leaf = node.func.attr
        if leaf == "tobytes":
            out.append(Violation(
                mod.path, node.lineno, "DR02",
                ".tobytes() outside durability/records.py — engine-"
                "state byte codecs are single-homed there (bit-exact "
                "leaf framing); route the array through a records.py "
                "codec or suppress with a reason naming what non-bank "
                "bytes these are"))
        elif leaf == "frombuffer":
            out.append(Violation(
                mod.path, node.lineno, "DR02",
                "frombuffer() outside durability/records.py — engine-"
                "state byte codecs are single-homed there; decode "
                "through a records.py codec or suppress with a reason "
                "naming what non-bank bytes these are"))
    return out


# ------------------------------------------------------------------- TL01

_TL01_PREFIX = "veneur."


def check_tl01(mod: PyModule, ctx: Context, config: dict) -> list:
    """Self-metric naming monopoly: a `veneur.*` string literal (or
    f-string head) outside observe/registry.py is an ad-hoc emission
    surface; the registry mints every self-metric name. Docstrings are
    exempt."""
    docstrings = _docstring_ids(mod.tree)
    fstring_parts = {id(v) for node in ast.walk(mod.tree)
                     if isinstance(node, ast.JoinedStr)
                     for v in node.values}
    out = []
    for node in ast.walk(mod.tree):
        lit = None
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if id(node) in docstrings or id(node) in fstring_parts:
                continue
            lit = node.value
        elif isinstance(node, ast.JoinedStr) and node.values and \
                isinstance(node.values[0], ast.Constant) and \
                isinstance(node.values[0].value, str):
            lit = node.values[0].value
        if lit is not None and lit.startswith(_TL01_PREFIX):
            out.append(Violation(
                mod.path, node.lineno, "TL01",
                f"ad-hoc veneur.* self-metric name {lit!r} outside the "
                "telemetry registry — veneur.* naming lives in "
                "observe/registry.py (TelemetryRegistry.drain / "
                "phase_timer_samples / flush_span_name); count through "
                "the registry or suppress with a reason"))
    return out


# ------------------------------------------------------------------- TR01

# the forward trace context's headers, the forward-kind marker and the
# envelope's gRPC metadata key; matched case-insensitively by prefix so a
# re-spelled header is still caught
_TR01_PREFIXES = ("x-veneur-trace", "x-veneur-interval-close",
                  "x-veneur-forward-kind", "veneur-envelope-bin")


def check_tr01(mod: PyModule, ctx: Context, config: dict) -> list:
    """Trace-context wire-encoding monopoly: those literals appear only
    in cluster/wire.py, which owns both directions of the encoding; two
    spellings are how sender and receiver drift apart. Docstrings are
    exempt."""
    docstrings = _docstring_ids(mod.tree)
    out = []
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Constant)
                and isinstance(node.value, str)):
            continue
        if id(node) in docstrings:
            continue
        if node.value.lower().startswith(_TR01_PREFIXES):
            out.append(Violation(
                mod.path, node.lineno, "TR01",
                f"trace-context wire literal {node.value!r} outside "
                "cluster/wire.py — the envelope/trace header and "
                "metadata encodings are single-homed there (use the "
                "wire.* codec helpers), or suppress with a reason"))
    return out


# ------------------------------------------------------------------- WC01

_WC01_LITERALS = ("centroids_q16", "packed_centroids")


def check_wc01(mod: PyModule, ctx: Context, config: dict) -> list:
    """q16 codec single-homing: the "centroids_q16" JSON key and the
    `packed_centroids` pb field appear only in cluster/wire.py, as
    literals or attribute access; encode and dequantize share one
    scale expression there. Docstrings are exempt."""
    docstrings = _docstring_ids(mod.tree)
    out = []
    for node in ast.walk(mod.tree):
        name = None
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if id(node) in docstrings:
                continue
            if node.value.lower().startswith(_WC01_LITERALS):
                name = node.value
        elif isinstance(node, ast.Attribute) and \
                node.attr in _WC01_LITERALS:
            name = node.attr
        if name is not None:
            out.append(Violation(
                mod.path, node.lineno, "WC01",
                f"quantized-centroid wire spelling {name!r} outside "
                "cluster/wire.py — the q16 encode/decode math and its "
                "carriers are single-homed there, or suppress with a "
                "reason"))
    return out


# ------------------------------------------------------------------- OV01

_OV01_COUNT_METHODS = ("incr", "mark")


def _ov01_counts(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in _OV01_COUNT_METHODS:
            return True
    return False


def check_ov01(mod: PyModule, ctx: Context, config: dict) -> list:
    """Counted degradation: in an admit*/fold*/shed* decision function,
    a drop verdict (`return None` or a bare `return`) has a registry
    counter update (.incr/.mark) in the same branch — the innermost
    enclosing if/loop/try, or the function body for a top-level return.
    An uncounted drop breaks `received == applied + counted_degraded`."""
    prefixes = tuple(config["ov01_decision_prefixes"])
    parents = _parent_map(mod.tree)
    out = []
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not fn.name.lstrip("_").startswith(prefixes):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Return):
                continue
            v = node.value
            if not (v is None or (isinstance(v, ast.Constant)
                                  and v.value is None)):
                continue
            branch: ast.AST = fn
            cur = parents.get(node)
            while cur is not None and cur is not fn:
                if isinstance(cur, (ast.If, ast.For, ast.While, ast.Try)):
                    branch = cur
                    break
                cur = parents.get(cur)
            if not _ov01_counts(branch):
                out.append(Violation(
                    mod.path, node.lineno, "OV01",
                    f"drop verdict in decision function `{fn.name}` "
                    "without a registry counter in the same branch — "
                    "degradation must be COUNTED (incr/mark) where it "
                    "is decided, or the accounting identity "
                    "`received == applied + counted_degraded` breaks "
                    "silently"))
    return out


# ------------------------------------------------------------------- SK01

_SK01_BANKS = ("TDigestBank", "HLLBank", "ULLBank", "REQBank")
_SK01_MODULES = ("ops.tdigest", "ops.hll",
                 "sketches.ull", "sketches.req",
                 "sketches.tdigest_engine", "sketches.hll_engine",
                 "kernels.compress", "kernels.ull_insert",
                 "kernels.hll_stats")
_SK01_LEAF_NAMES = ("tdigest", "hll", "ull", "req",
                    "tdigest_engine", "hll_engine",
                    "compress", "ull_insert", "hll_stats")


def check_sk01(mod: PyModule, ctx: Context, config: dict) -> list:
    """Sketch-engine registry boundary: outside sketches/, ops/,
    kernels/ and parallel/, code holds an engine object from the
    registry (sketches.histogram_engine/set_engine). Flagged: imports
    of a sketch implementation module and constructions of the bank
    NamedTuples."""
    out = []
    msg = ("outside the registry boundary — obtain an engine object from "
           "veneur_tpu_torch.sketches (histogram_engine/set_engine) "
           "instead, or suppress with a reason")
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom):
            module = node.module or ""
            hit = any(module.endswith(t) or module == t.rsplit(".")[-1]
                      for t in _SK01_MODULES)
            names = {a.name for a in node.names}
            if not hit and module.endswith(("ops", "sketches", "kernels")):
                hit = bool(names & set(_SK01_LEAF_NAMES))
            if hit:
                out.append(Violation(
                    mod.path, node.lineno, "SK01",
                    f"direct sketch-module import ({module!r}) " + msg))
        elif isinstance(node, ast.Import):
            for a in node.names:
                if any(a.name.endswith(t) for t in _SK01_MODULES):
                    out.append(Violation(
                        mod.path, node.lineno, "SK01",
                        f"direct sketch-module import ({a.name!r}) "
                        + msg))
        elif isinstance(node, ast.Call):
            d = dotted(node.func)
            if d is not None and d.rsplit(".", 1)[-1] in _SK01_BANKS:
                out.append(Violation(
                    mod.path, node.lineno, "SK01",
                    f"{d.rsplit('.', 1)[-1]} constructed outside "
                    "sketches/ + ops/ — banks built outside the owning "
                    "engine bypass its invariants (cluster order, "
                    "register packing, level layout); build through the "
                    "engine object or suppress with a reason"))
    return out


# ------------------------------------------------------------------- DS01

_DS01_BANK_ATTRS = ("histo_bank", "counter_bank", "gauge_bank", "set_bank")
_DS01_LANDING_LEAVES = ("merge_rows", "merge_centroids", "merge_scalars",
                        "counter_merge", "gauge_set")
_DS01_MARK_LEAVES = ("_mark_dirty", "_mark_dirty_into")


def _ds01_direct_mark(fn: ast.AST) -> bool:
    """Does `fn` mark a dirty bitmap itself: a _mark_dirty(_into) call,
    or a subscript store on something named dirty?"""
    for n in ast.walk(fn):
        if isinstance(n, ast.Call):
            d = dotted(n.func)
            if d is not None and d.rsplit(".", 1)[-1] in _DS01_MARK_LEAVES:
                return True
        elif isinstance(n, (ast.Assign, ast.AugAssign)):
            targets = (n.targets if isinstance(n, ast.Assign)
                       else [n.target])
            for t in targets:
                if not isinstance(t, ast.Subscript):
                    continue
                base = t
                while isinstance(base, ast.Subscript):
                    base = base.value
                name = (base.attr if isinstance(base, ast.Attribute)
                        else base.id if isinstance(base, ast.Name)
                        else "")
                if "dirty" in name:
                    return True
    return False


def _ds01_landing_lines(fn: ast.AST) -> list:
    """Lines of device-landing bank writes in `fn`: a `*_bank` attribute
    assignment, a `self._kern[...]` dispatch, a bank-landing leaf."""
    lines = []
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign):
            targets = []
            for t in n.targets:
                targets.extend(t.elts if isinstance(
                    t, (ast.Tuple, ast.List)) else [t])
            if any(isinstance(t, ast.Attribute)
                   and t.attr in _DS01_BANK_ATTRS for t in targets):
                lines.append(n.lineno)
        elif isinstance(n, ast.Call):
            if isinstance(n.func, ast.Subscript) and isinstance(
                    n.func.value, ast.Attribute) \
                    and n.func.value.attr == "_kern":
                lines.append(n.lineno)
            else:
                d = dotted(n.func)
                if d is not None and \
                        d.rsplit(".", 1)[-1] in _DS01_LANDING_LEAVES:
                    lines.append(n.lineno)
    return sorted(set(lines))


def check_ds01(mod: PyModule, ctx: Context, config: dict) -> list:
    """Dirty-bitmap marking: the bitmap feeds the incremental flush and
    the delta checkpoints, so every function of the pipeline module
    with a device-landing bank write marks it, directly or through a
    (transitively) marking function of the module. One finding per
    function, at its first landing line; non-landing writes suppress
    with a reason."""
    fns = [n for n in ast.walk(mod.tree)
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    marking = {fn.name for fn in fns if _ds01_direct_mark(fn)}
    changed = True
    while changed:
        changed = False
        for fn in fns:
            if fn.name in marking:
                continue
            for n in ast.walk(fn):
                if isinstance(n, ast.Call):
                    d = dotted(n.func)
                    if d is not None and d.rsplit(".", 1)[-1] in marking:
                        marking.add(fn.name)
                        changed = True
                        break
    out = []
    for fn in fns:
        lines = _ds01_landing_lines(fn)
        if not lines or fn.name in marking:
            continue
        out.append(Violation(
            mod.path, lines[0], "DS01",
            f"device-landing bank write in `{fn.name}` without a "
            "dirty-bitmap mark — the bitmap feeds the incremental "
            "flush AND delta checkpoints, so an unmarked landing "
            "silently drops the slot from both; mark via "
            "_mark_dirty(_into) (or a marking helper), or suppress "
            "with a reason proving this write is not a data landing"))
    return out


# ------------------------------------------------------------------- QT01

def check_qt01(mod: PyModule, ctx: Context, config: dict) -> list:
    """Query-tier read-path isolation: the time-travel query module never
    takes an engine's ingest/flush lock (`with <x>.lock:`,
    `<x>.lock.acquire()`) nor writes a live bank attribute; it works on
    scratch engines through their public surface."""
    out = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.With):
            for item in node.items:
                e = item.context_expr
                if isinstance(e, ast.Attribute) and e.attr == "lock":
                    out.append(Violation(
                        mod.path, node.lineno, "QT01",
                        "query-path code acquires an engine lock "
                        "(`with <x>.lock:`) — the read tier must never "
                        "take the ingest/flush lock; go through the "
                        "scratch engine's public surface or suppress "
                        "with a reason naming the non-engine lock"))
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "acquire" \
                    and isinstance(f.value, ast.Attribute) \
                    and f.value.attr == "lock":
                out.append(Violation(
                    mod.path, node.lineno, "QT01",
                    "query-path code calls <x>.lock.acquire() — the "
                    "read tier must never take the ingest/flush lock; "
                    "suppress with a reason naming the non-engine "
                    "lock"))
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                    else [t]
                for e in elts:
                    if isinstance(e, ast.Attribute) \
                            and e.attr in _DS01_BANK_ATTRS:
                        out.append(Violation(
                            mod.path, node.lineno, "QT01",
                            f"query-path code writes `<x>.{e.attr}` — "
                            "the read tier must never write live "
                            "banks; restore into a scratch engine via "
                            "restore_checkpoint instead"))
    return out


CHECKS = {
    "TH01": check_th01, "CF01": check_cf01, "RS01": check_rs01,
    "SR02": check_sr02, "DR01": check_dr01, "DR02": check_dr02,
    "TL01": check_tl01, "TR01": check_tr01, "WC01": check_wc01,
    "OV01": check_ov01, "SK01": check_sk01, "DS01": check_ds01,
    "QT01": check_qt01,
}
