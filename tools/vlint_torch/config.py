"""Default configuration of the port's checks.

Every path entry is a substring of the posix-normalised file path, so
the tool behaves the same from the repo root or with absolute paths.
`scope[code]` names where a check applies: the port's own files, plus a
`/<code>_` marker that scopes the check's fixtures in
(tests/vlint_torch_fixtures/). `allow[code]` names the home modules a
single-homing check exempts.
"""

PKG = "veneur_tpu_torch/"

DEFAULT_CONFIG = {
    "scope": {
        # TH01: the files whose classes run methods on several threads:
        # the server's listeners, workers and flusher, the HTTP API's
        # handler threads, the sinks' sender and flush threads, and the
        # mesh engine's flush under its lock
        "TH01": (PKG + "server.py", PKG + "http_api.py", PKG + "sinks/",
                 PKG + "parallel/engine.py", "/th01_"),
        "CF01": (PKG, "/cf01_"),
        "RS01": (PKG, "/rs01_"),
        "SR02": (PKG, "/sr02_"),
        "DR01": (PKG + "durability/", "/dr01_"),
        "DR02": (PKG + "durability/", PKG + "models/", PKG + "ops/",
                 PKG + "cluster/", "/dr02_"),
        "TL01": (PKG, "/tl01_"),
        "TR01": (PKG, "/tr01_"),
        "WC01": (PKG, "/wc01_"),
        "OV01": (PKG + "ingest/", "/ov01_"),
        "SK01": (PKG, "/sk01_"),
        "DS01": (PKG + "models/pipeline.py", "/ds01_"),
        "QT01": (PKG + "durability/history.py", "/qt01_"),
        "HK01": (PKG, "/hk01_"),
        "HK02": (PKG, "/hk02_"),
        "HK03": (PKG, "/hk03_"),
    },
    "allow": {
        # the resilience layer owns the one raw transport
        "RS01": (PKG + "resilience.py",),
        # the owners of TDigestBank.mean/weight: the cluster core and
        # REQ, whose REQBank also has a `weight` field
        "SR02": (PKG + "ops/tdigest.py", PKG + "sketches/req.py"),
        # the journal owns framing, fsync and atomic rename
        "DR01": (PKG + "durability/journal.py",),
        # the record codecs are the one home of bank-leaf bytes
        "DR02": (PKG + "durability/records.py",),
        # the telemetry registry mints every veneur.* name
        "TL01": (PKG + "observe/registry.py",),
        # the wire owns the trace headers and the q16 row
        "TR01": (PKG + "cluster/wire.py",),
        "WC01": (PKG + "cluster/wire.py",),
        # the engine registry, the sketch math, the kernels that are its
        # twins, and the mesh engine, which owns sharded banks
        "SK01": (PKG + "sketches/", PKG + "ops/", PKG + "kernels/",
                 PKG + "parallel/"),
    },
    # TH01: methods ending so run under a lock their caller holds
    "th01_locked_suffixes": ("_locked",),
    # CF01 leg (a): call families checked for sibling parity
    "cf01_prefixes": ("start",),
    # CF01 leg (b): the modules whose `Config` dataclass keys must each
    # reach a consumer outside the module
    "cf01_config_modules": (PKG + "config.py", "/cf01_config_"),
    # OV01: decision-function name prefixes
    "ov01_decision_prefixes": ("admit", "fold", "shed"),
    # HK01: where a hand-written kernel, its build and its library load
    # may live; `variants/` holds kernel sources no main path builds
    "hk01_homes": (PKG + "kernels/", PKG + "csrc/", "/hk01_kernels_"),
    "hk01_unwired": (PKG + "variants/",),
}
