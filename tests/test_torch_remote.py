"""The port's copies of the remote basket service, fault injection, repair
and the obs tools, held to the JAX package's on the same files and the
same wire: a port server read by the reference's client and the reverse
(every branch byte-identical), the golden wire blobs, scrub and replica
repair reports, the heat log, the SLO engine, the obs CLI, the fault plan
and a chaos proxy.  These modules are numpy only: no torch here."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import repro.fault as ref_fault
import repro.obs.heat as ref_heat
import repro.obs.slo as ref_slo
import repro.remote as ref_remote
import repro.repair as ref_repair
import repro_torch.fault as port_fault
import repro_torch.obs.heat as port_heat
import repro_torch.obs.slo as port_slo
import repro_torch.remote as port_remote
import repro_torch.repair as port_repair
from repro.io import fdcache as ref_fdcache
from repro_torch.core.bfile import BasketFile, write_arrays
from repro_torch.core.codec import CompressionConfig
from repro_torch.data.events import write_event_file
from repro_torch.io import fdcache as port_fdcache
from repro_torch.obs import metrics as M

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
PKG = {"port": port_remote, "reference": ref_remote}


@pytest.fixture(scope="module")
def served_dir(tmp_path_factory):
    td = tmp_path_factory.mktemp("remote")
    events = write_event_file(str(td / "events.bskt"), n_events=1500,
                              profile="analysis", basket_bytes=4096)
    arch = {"Jet_pt": events["Jet_pt"], "Jet_offsets": events["Jet_offsets"]}
    write_arrays(str(td / "archive.bskt"), arch,
                 cfg_for=lambda n, a: CompressionConfig("lzma", 2, "shuffle"),
                 target_basket_bytes=16 * 1024)
    return td


@pytest.mark.parametrize("wire", [None, "auto"])
@pytest.mark.parametrize("server,client", [("port", "reference"),
                                           ("reference", "port"),
                                           ("port", "port")])
def test_every_branch_byte_identical_across_packages(served_dir, server,
                                                     client, wire):
    with PKG[server].BasketServer(str(served_dir), workers=2) as srv:
        srv.start()
        for name in ("events.bskt", "archive.bskt"):
            with BasketFile(str(served_dir / name)) as local, \
                    PKG[client].RemoteBasketFile(
                        srv.url(name), wire=wire,
                        objective="max_read_tput") as rf:
                assert rf.branch_names() == local.branch_names()
                assert rf.generation == local.generation
                for b in local.branch_names():
                    a, r = local.read_branch(b), rf.read_branch(b)
                    assert a.dtype == r.dtype and a.shape == r.shape
                    assert a.tobytes() == r.tobytes(), (name, b)
                    assert rf.read_entries(b, 5, 60).tobytes() == \
                        local.read_entries(b, 5, 60).tobytes()


def _frames(blob: bytes, P) -> list:
    import io
    r, out = io.BytesIO(blob), []
    while True:
        try:
            out.append(P.read_frame(r))
        except EOFError:
            return out


@pytest.mark.parametrize("golden", ["wire_pr5.bin", "wire_pr9.bin"])
def test_golden_wire_blobs_parse_and_repack(golden):
    """The port parses the committed wire blobs as the reference does, and
    packs what it parsed back to the same bytes."""
    from repro.remote import protocol as RP
    from repro_torch.remote import protocol as PP
    with open(os.path.join(GOLDEN, golden), "rb") as f:
        blob = f.read()
    mine, theirs = _frames(blob, PP), _frames(blob, RP)
    assert mine == theirs and len(mine) >= 3
    assert b"".join(PP.pack_frame(t, body, payload or b"")
                    for t, body, payload in mine) == blob
    assert (PP.REQ_READV, PP.RESP_ERROR, PP.MAGIC) == \
        (RP.REQ_READV, RP.RESP_ERROR, RP.MAGIC)


def test_url_and_coalesce_match_the_reference():
    from repro.remote import protocol as RP
    from repro_torch.remote import protocol as PP
    assert PP.parse_url("repro://h:9147/a/b.bskt") == \
        RP.parse_url("repro://h:9147/a/b.bskt")
    ranges = [(0, 10, 0), (10, 5, 1), (40_000, 100, 2), (200_000, 8, 3),
              (5, 20, 4)]
    assert PP.coalesce(ranges) == RP.coalesce(ranges)


def _corpus(path, seed=17, parity=4):
    rng = np.random.default_rng(seed)
    arrays = {"a": rng.integers(0, 1 << 20, 6_000).astype(np.int64),
              "b": rng.standard_normal(6_000).astype(np.float32)}
    write_arrays(path, arrays,
                 cfg_for=lambda n, a: CompressionConfig("none", 0, "none"),
                 target_basket_bytes=1024, parity=parity)
    return arrays


def _stable(report: dict) -> dict:
    return {k: v for k, v in report.items()
            if k not in ("path", "seconds", "elapsed_s", "mbps")}


@pytest.mark.parametrize("every", [5, 2])
def test_scrub_reports_equal_the_reference(tmp_path, every):
    """The same rot (``rot_container``, each package's) scrubbed by each
    package: equal reports and byte-identical containers after; ``every=2``
    leaves stripes parity cannot heal."""
    p = str(tmp_path / "port.bskt")
    _corpus(p)
    r = str(tmp_path / "ref.bskt")
    shutil.copyfile(p, r)
    shutil.copyfile(p + ".parity", r + ".parity")
    dp = port_fault.rot_container(p, seed=23, every=every)
    dr = ref_fault.rot_container(r, seed=23, every=every)
    assert dp == dr and dp
    port_fdcache.invalidate(p)
    ref_fdcache.invalidate(r)
    got = port_repair.scrub_container(p)
    want = ref_repair.scrub_container(r)
    assert _stable(got) == _stable(want)
    assert got["corrupt"] == len(dp)
    with open(p, "rb") as a, open(r, "rb") as b:
        assert a.read() == b.read()
    port_fdcache.invalidate(p)
    ref_fdcache.invalidate(r)


def test_repair_replica_equals_the_reference(tmp_path):
    """A replica rotted past its parity pulls good bytes from a peer served
    by the other package's server; both packages' reconciles converge to
    the peer's bytes with the same report."""
    peer = tmp_path / "peer"
    peer.mkdir()
    arrays = _corpus(str(peer / "c.bskt"), parity=0)
    reports = {}
    for who, repair, fault, srv_pkg in (
            ("port", port_repair, port_fault, ref_remote),
            ("reference", ref_repair, ref_fault, port_remote)):
        local = str(tmp_path / f"{who}.bskt")
        shutil.copyfile(peer / "c.bskt", local)
        assert fault.rot_container(local, seed=5, every=3)
        port_fdcache.invalidate(local)
        ref_fdcache.invalidate(local)
        with srv_pkg.BasketServer(str(peer), workers=0) as srv:
            srv.start()
            rep = repair.repair_replica(local, "c.bskt", [(srv.host, srv.port)])
        reports[who] = rep
        assert rep["converged"] and not rep["remaining"], rep
        port_fdcache.invalidate(local)
        with BasketFile(local) as f:
            for name, arr in arrays.items():
                assert f.read_branch(name).tobytes() == arr.tobytes()
    a, b = reports["port"], reports["reference"]
    assert {k: a[k] for k in ("divergent", "pulled", "patched", "rewritten")} \
        == {k: b[k] for k in ("divergent", "pulled", "patched", "rewritten")}
    assert _stable(a["scrub"]) == _stable(b["scrub"])
    cats = {"a": {"x": {"baskets": [{"meta": {"checksum": 1, "orig_len": 8,
                                              "entry_start": 0,
                                              "entry_count": 2}}]}},
            "b": {}}
    assert port_repair.diff_catalogs(cats) == ref_repair.diff_catalogs(cats)


def test_heat_sidecar_crosses_the_packages(tmp_path):
    """A heat log written by the port is read and ranked by the reference
    as the port ranks it, and the reverse."""
    p = str(tmp_path / "a.bskt")
    q = str(tmp_path / "b.bskt")
    for heat, path in ((port_heat, p), (ref_heat, q)):
        hl = heat.HeatLog(halflife_s=3600.0)
        for _ in range(40):
            hl.record(path, "hot", [0, 1], 2048)
        hl.record(path, "cold", [5], 64)
        hl.flush()
    for path in (p, q):
        doc_p = port_heat.load_sidecar(path + ".heat")
        doc_r = ref_heat.load_sidecar(path + ".heat")
        assert doc_p == doc_r and doc_p is not None
        now = max(b["t"] for b in doc_p["branches"].values()) + 60.0
        assert port_heat.rank_branches(doc_p, now=now) == \
            ref_heat.rank_branches(doc_r, now=now)
        assert port_heat.rank_branches(doc_p, now=now)[0][0] == "hot"
    assert port_heat._decay(100.0, 120.0, 60.0) == \
        ref_heat._decay(100.0, 120.0, 60.0)


def _snap(verb, n, lat):
    b = M.bucket_index(lat)
    return {"counters": {M.format_key("server.requests", {"verb": verb}): n},
            "gauges": {},
            "hists": {M.format_key("server.request_s", {"verb": verb}): {
                "count": n, "sum": n * lat, "buckets": {str(b): n},
                "bsums": {str(b): n * lat}}}}


def test_slo_engine_judges_as_the_reference():
    engines = []
    for slo in (port_slo, ref_slo):
        eng = slo.SLOEngine([slo.SLOSpec("readv-latency", "readv",
                                         p99_s=0.250)], max_ticks=16)
        eng.tick(_snap("readv", 100, 0.010), t=1000.0)
        eng.tick(_snap("readv", 300, 0.010), t=1005.0)
        slow = _snap("readv", 500, 0.010)
        b = M.bucket_index(2.0)
        h = slow["hists"][M.format_key("server.request_s", {"verb": "readv"})]
        h["count"] += 100
        h["sum"] += 200.0
        h["buckets"][str(b)] = 100
        h["bsums"][str(b)] = 200.0
        eng.tick(slow, t=1010.0)
        engines.append(eng.evaluate(now=1010.0))
    assert engines[0] == engines[1]
    assert not engines[0][0]["ok"]


def test_obs_cli_against_a_port_server(served_dir, capsys):
    """``python -m repro_torch.obs HOST:PORT --json`` reads a port server's
    STATS with the sections the reference's CLI prints; the stitch mode
    gives the reference's output on the same trace files."""
    from repro.obs.__main__ import main as ref_main
    from repro_torch.obs.__main__ import main as port_main
    with port_remote.BasketServer(str(served_dir), workers=0) as srv:
        srv.start()
        with port_remote.RemoteBasketFile(srv.url("events.bskt"),
                                          wire=None) as rf:
            rf.read_branch("Jet_pt")
        target = f"{srv.host}:{srv.port}"
        assert port_main([target, "--json"]) == 0
        mine = json.loads(capsys.readouterr().out)
        assert ref_main([target, "--json"]) == 0
        theirs = json.loads(capsys.readouterr().out)
    assert sorted(mine) == sorted(theirs)
    assert sorted(mine["server"]) == sorted(theirs["server"])
    assert mine["server"]["requests"] > 0
    assert sorted(mine["metrics"]) == ["counters", "gauges", "hists"]
    trace = {"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0, "dur": 5, "pid": 1, "tid": 1,
         "args": {"trace_id": "0" * 31 + "1", "span_id": "0" * 15 + "1"}},
        {"name": "b", "ph": "X", "ts": 1, "dur": 2, "pid": 2, "tid": 1,
         "args": {"trace_id": "0" * 31 + "1", "span_id": "0" * 15 + "2",
                  "parent_id": "0" * 15 + "1"}}]}
    a = served_dir / "t.json"
    a.write_text(json.dumps(trace))
    outs = []
    for main, out in ((port_main, served_dir / "p.json"),
                      (ref_main, served_dir / "r.json")):
        assert main(["--stitch", str(out), str(a)]) == 0
        capsys.readouterr()
        outs.append(json.loads(out.read_text()))
    assert outs[0] == outs[1]


def test_remote_cli_serves_a_directory(served_dir):
    """``python -m repro_torch.remote DIR --port 0`` serves what the
    reference's client reads byte for byte."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.remote", str(served_dir),
         "--port", "0", "--workers", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("serving "), line
        hostport = line.rsplit(" on ", 1)[1]
        with ref_remote.RemoteBasketFile(f"repro://{hostport}/events.bskt") \
                as rf, BasketFile(str(served_dir / "events.bskt")) as local:
            assert rf.read_branch("Jet_pt").tobytes() == \
                local.read_branch("Jet_pt").tobytes()
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        proc.stdout.close()


def test_fault_plans_decide_as_the_reference():
    specs = ["garble:p=0.3,dir=s2c,verb=readv", "delay:every=3,ms=10",
             "drop:max=2"]
    for spec in specs:
        assert vars(port_fault.parse_rule(spec)) == \
            vars(ref_fault.parse_rule(spec))
    plans = [pkg.FaultPlan([pkg.parse_rule(s) for s in specs], seed=11)
             for pkg in (port_fault, ref_fault)]
    events = [dict(conn_id=c, direction=d, verb=v, frame_no=n)
              for c in range(3) for d in ("c2s", "s2c")
              for v in ("readv", "catalog") for n in range(1, 8)]
    got = [[[r.kind for r in pl.decide(**e)] for e in events] for pl in plans]
    assert got[0] == got[1]
    assert plans[0].counts() == plans[1].counts()
    buf = bytes(range(256)) * 4
    from repro.fault.inject import garble_byte as ref_garble
    from repro_torch.fault.inject import garble_byte
    assert garble_byte(buf, 3, 7) == ref_garble(buf, 3, 7) != buf


@pytest.mark.parametrize("kind", ["garble", "reset"])
def test_chaos_proxy_fault_retried_to_success(tmp_path, kind):
    """The port's chaos proxy in front of the reference's server: one fault
    on the first READV, and the port's client retries to the right bytes."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 1 << 30, 40_000).astype(np.int64)
    write_arrays(str(tmp_path / "x.bskt"), {"a": a},
                 cfg_for=lambda n, v: CompressionConfig("zlib", 1, "shuffle8"),
                 target_basket_bytes=32 * 1024)
    direction = "s2c" if kind == "garble" else "c2s"
    plan = port_fault.FaultPlan([port_fault.FaultRule(
        kind, direction=direction, verb="readv", max_fires=1)], seed=7)
    with ref_remote.BasketServer(str(tmp_path), workers=0) as srv:
        srv.start()
        with port_fault.ChaosProxy(srv.host, srv.port, plan) as proxy, \
                port_remote.RemoteBasketFile(
                    host=proxy.host, port=proxy.port, path="x.bskt",
                    wire=None, timeout=2.0, retries=4, backoff=0.01) as rf:
            assert rf.read_branch("a").tobytes() == a.tobytes()
    assert plan.counts().get(kind) == 1
