"""The port's ingestion RPC (``reflow_tpu_torch.serve.rpc``): the
``IngestFrontend.submit() -> Ticket`` contract over the wire, against
``tests/test_rpc.py`` and the JAX package, on the CPU.

Every test of ``tests/test_rpc.py`` has a counterpart here, over
``LoopbackTransport`` (same framing, same protocol, no kernel), and each
runs over the port's CPU oracle (string keys) and over its ``"cuda"``
executor at ``device="cpu"`` (integer keys interned into one
vocabulary). The load-bearing invariant is exactly-once across producer
death: a producer that dies mid-submit resubmits the same ``batch_id``,
the ``hello`` dedup handshake reports it admitted, and the fold count
stays one.

Across the packages, over ``TcpTransport`` on ``127.0.0.1`` (every wait
bounded): a JAX ``RemoteProducer`` submits to a port ``RpcIngestServer``
and a port producer to a JAX server, with the same acknowledgements; the
same requests make byte-identical frames in both packages; and a device
batch goes over the wire as its host copy, never as a tensor.
"""

import pytest
import torch

import reflow_tpu_torch as P
from reflow_tpu_torch.executors.cpu import CpuExecutor
from reflow_tpu_torch.executors.device_delta import to_device
from reflow_tpu_torch.net import FrameError, LoopbackTransport, TcpTransport
from reflow_tpu_torch.serve import (APPLIED, DEDUPED, REJECTED,
                                    IngestFrontend, RemoteProducer,
                                    RpcIngestServer)
from reflow_tpu_torch.wal import DurableScheduler
from reflow_tpu_torch.workloads import wordcount


#: the executor the tests run on (set by ``kind``)
_KIND = ["cpu"]
#: one vocabulary for every integer-keyed graph: a word's key is fixed
_VOCAB: dict = {}
KEY_SPACE = 1 << 10


@pytest.fixture(params=["cpu", "cuda"])
def kind(request):
    _KIND[0] = request.param
    yield request.param
    _KIND[0] = "cpu"


def key(word: str):
    """A word's key in the sink's view on the current executor."""
    return _VOCAB[word] if _KIND[0] == "cuda" else word


def make_stack(tmp_path, *, start=True, max_tickets=None):
    if _KIND[0] == "cuda":
        g, src, sink = wordcount.build_graph(KEY_SPACE)
        ex = P.get_executor("cuda", device="cpu")
    else:
        g, src, sink = wordcount.build_graph()
        ex = CpuExecutor()
    sched = DurableScheduler(g, ex, wal_dir=str(tmp_path / "wal"),
                             fsync="tick")
    fe = IngestFrontend(sched, start=start)
    lt = LoopbackTransport()
    srv = RpcIngestServer(fe, lt, max_tickets=max_tickets).start()
    return sched, fe, lt, srv, src, sink


def batch(words: str):
    if _KIND[0] == "cuda":
        return wordcount.ingest_lines([words], vocab=_VOCAB)
    return wordcount.ingest_lines([words])


def test_submit_applied_deduped_and_status(tmp_path, kind):
    sched, fe, lt, srv, src, sink = make_stack(tmp_path)
    prod = RemoteProducer(lt, srv.address, name="p0")
    try:
        t = prod.submit(src, batch("aa bb aa"), batch_id="b0")
        res = t.result(10)
        assert res.status == APPLIED
        assert res.lsn is not None          # durable before the ack
        assert res.tick >= 0
        assert prod.in_doubt_ids() == ()
        # the hello handshake carried the server's identity
        assert prod.last_hello["graph"] == sched.graph.name
        assert prod.last_hello["epoch"] == 0

        # same id again: the dedup mirror collapses it, one fold total
        t2 = prod.submit(src, batch("aa bb aa"), batch_id="b0")
        assert t2.result(10).status == DEDUPED
        assert prod.deduped_total == 1
        fe.flush()
        assert sched.view(sink.name)[(key("aa"), 2.0)] == 1
        assert srv.submits_total == 2
    finally:
        prod.close()
        srv.close()
        fe.close()
        sched.wal.close()


def test_unknown_source_rejects_deterministically(tmp_path, kind):
    sched, fe, lt, srv, src, sink = make_stack(tmp_path)
    prod = RemoteProducer(lt, srv.address, name="p0")
    try:
        t = prod.submit("no-such-source", batch("xx"), batch_id="b0")
        res = t.result(10)
        # a protocol rejection resolves the ticket (retrying the same
        # request cannot succeed) instead of parking it in doubt
        assert res.status == REJECTED
        assert "no-such-source" in res.reason
        assert prod.in_doubt_ids() == ()
    finally:
        prod.close()
        srv.close()
        fe.close()
        sched.wal.close()


def test_resubmit_after_producer_death_exactly_once(tmp_path, kind):
    """The reconnect-dedup satellite: producer dies mid-submit, the
    respawned producer resubmits the same batch_id — the hello
    handshake reports it admitted, the resolve says DEDUPED, and the
    batch folded exactly once."""
    sched, fe, lt, srv, src, sink = make_stack(tmp_path)
    prod1 = RemoteProducer(lt, srv.address, name="p0")
    # submit and die without learning the fate — the ack window is
    # exactly where a kill -9 leaves a real producer in doubt
    prod1.submit(src, batch("zz0 zz1 zz0"), batch_id="boom-1")
    prod1.close()

    prod2 = RemoteProducer(lt, srv.address, name="p0-respawn")
    try:
        t = prod2.submit(src, batch("zz0 zz1 zz0"), batch_id="boom-1")
        res = t.result(10)
        assert res.status == DEDUPED
        # the handshake made the outcome observable: the dial inside
        # submit() carried the in-doubt id, the mirror remembered it
        assert "boom-1" in prod2.last_hello["admitted"]
        assert prod2.deduped_total == 1
        fe.flush()
        view = sched.view(sink.name)
        assert view[(key("zz0"), 2.0)] == 1   # one fold, not two
        assert view[(key("zz1"), 1.0)] == 1
    finally:
        prod2.close()
        srv.close()
        fe.close()
        sched.wal.close()


def test_link_reset_resubmits_on_replacement_endpoint(tmp_path, kind):
    """A server restart (the promoted-replacement shape: empty ticket
    table, recovered mirror) never double-folds and never loses an
    acked write — the producer re-dials, re-handshakes and resubmits."""
    sched, fe, lt, srv, src, sink = make_stack(tmp_path)
    prod = RemoteProducer(lt, srv.address, name="p0")
    srv2 = None
    try:
        assert prod.submit(src, batch("m0"),
                           batch_id="b0").result(10).status == APPLIED
        srv.close()                       # the link resets under us
        t = prod.submit(src, batch("m1 m1"), batch_id="b1")
        assert not t.done()               # in doubt, payload retained
        srv2 = RpcIngestServer(fe, lt).start()   # same frontend
        prod.retarget(srv2.address)
        res = t.result(10)
        assert res.status in (APPLIED, DEDUPED)
        assert prod.reconnects_total >= 1
        assert prod.submits_total >= 3    # b0 + b1 + the resubmit
        fe.flush()
        assert sched.view(sink.name)[(key("m1"), 2.0)] == 1   # one fold
        assert prod.in_doubt_ids() == ()
    finally:
        prod.close()
        if srv2 is not None:
            srv2.close()
        srv.close()
        fe.close()
        sched.wal.close()


def test_ticket_eviction_resolves_unknown_then_dedups(tmp_path, kind):
    """The bounded ticket table: an evicted in-flight ticket resolves
    "unknown", the producer resubmits, and the dedup mirror keeps the
    duplicate from folding twice."""
    # no pump: tickets stay undecided, making the eviction deterministic
    sched, fe, lt, srv, src, sink = make_stack(tmp_path, start=False,
                                               max_tickets=1)
    prod = RemoteProducer(lt, srv.address, name="p0")
    try:
        t0 = prod.submit(src, batch("e0"), batch_id="b0")
        prod.submit(src, batch("e1"), batch_id="b1")  # evicts b0
        assert srv.evicted_tickets == 1
        # driving b0 now resolves it: resolve -> "unknown" -> resubmit
        # -> DEDUPED against the mirror (b0 was admitted, just evicted)
        res = t0.result(10)
        assert res.status == DEDUPED
        assert prod.deduped_total == 1
        assert prod.resubmits_total >= 1
    finally:
        prod.close()
        srv.close()
        fe.close(flush=False)   # nothing pumps the queued batches
        sched.wal.close()


def test_flush_view_and_ping_ops(tmp_path, kind):
    """The sideband ops the bench leans on: flush quiesces the
    frontend, view reads the sink at the current tick, ping reports
    graph/tick/lsn/state."""
    sched, fe, lt, srv, src, sink = make_stack(tmp_path)
    prod = RemoteProducer(lt, srv.address, name="p0")
    try:
        for i in range(3):
            prod.submit(src, batch("vv ww"), batch_id=f"b{i}")
        prod.flush(10)
        conn = lt.connect(srv.address)
        try:
            conn.send_msg(("flush", 10.0))
            assert conn.recv_msg(10.0) == ("ok",)
            conn.send_msg(("view", sink.name))
            ok, tick, view = conn.recv_msg(10.0)
            assert ok == "ok" and tick == sched._tick
            assert view[(key("vv"), 3.0)] == 1
            conn.send_msg(("ping",))
            ok, st = conn.recv_msg(10.0)
            assert st["tick"] == sched._tick and st["state"] == "running"
            conn.send_msg(("bogus",))
            assert conn.recv_msg(10.0)[0] == "err"
        finally:
            conn.close()
    finally:
        prod.close()
        srv.close()
        fe.close()
        sched.wal.close()


# -- across the packages, over TCP ------------------------------------------

def _stack(pkg, tmp_path):
    """A durable word-count leader on ``pkg``'s CPU oracle, its frontend
    and an RPC server on a TCP listener (127.0.0.1, port 0)."""
    if pkg == "jax":
        from reflow_tpu.serve import IngestFrontend as F
        from reflow_tpu.serve import RpcIngestServer as S
        from reflow_tpu.wal import DurableScheduler as D
        from reflow_tpu.workloads import wordcount as W
        from reflow_tpu.net import TcpTransport as T
        g, src, sink = W.build_graph()
        sched = D(g, wal_dir=str(tmp_path / f"wal-{pkg}"), fsync="tick")
    else:
        F, S, T, W = IngestFrontend, RpcIngestServer, TcpTransport, wordcount
        g, src, sink = W.build_graph()
        sched = DurableScheduler(g, CpuExecutor(),
                                 wal_dir=str(tmp_path / f"wal-{pkg}"),
                                 fsync="tick")
    fe = F(sched)
    srv = S(fe, T()).start()
    return sched, fe, srv, src, sink, W


def _producer(pkg, address):
    if pkg == "jax":
        from reflow_tpu.net import TcpTransport as T
        from reflow_tpu.serve import RemoteProducer as R
    else:
        T, R = TcpTransport, RemoteProducer
    return R(T(), address, name="p0", io_timeout_s=5.0)


def _session(prod, src, W):
    """One producer session: applied, deduped, rejected, applied; the
    results' fields in order."""
    out = []
    for bid, source, words in (("b0", src, "aa bb aa"),
                               ("b0", src, "aa bb aa"),
                               ("bx", "no-such-source", "cc"),
                               ("b1", src, "bb dd")):
        res = prod.submit(source, W.ingest_lines([words]),
                          batch_id=bid).result(10)
        out.append((res.status, res.batch_id, res.tick, res.lsn,
                    res.coalesced_with))
    return out


@pytest.mark.parametrize("server,producer", [("jax", "jax"),
                                             ("port", "jax"),
                                             ("jax", "port"),
                                             ("port", "port")])
def test_rpc_across_packages_same_acks(tmp_path, server, producer):
    """A producer of either package submits over TCP to a server of
    either: the acknowledgements (status, tick, lsn) and the folded view
    are the same in all four pairings."""
    sched, fe, srv, src, sink, W = _stack(server, tmp_path)
    prod = _producer(producer, srv.address)
    try:
        got = _session(prod, src.name, W)
        assert [g[0] for g in got] == [APPLIED, DEDUPED, REJECTED, APPLIED]
        assert got[0][3] is not None and got[3][3] > got[0][3]
        assert prod.in_doubt_ids() == ()
        fe.flush()
        view = dict(sched.view(sink.name))
        assert view == {("aa", 2.0): 1, ("bb", 2.0): 1, ("dd", 1.0): 1}
        # the reference pairing (JAX to JAX) gives the same acks
        ref_dir = tmp_path / "ref"
        ref_dir.mkdir()
        rsched, rfe, rsrv, rsrc, _rsink, RW = _stack("jax", ref_dir)
        rprod = _producer("jax", rsrv.address)
        try:
            assert _session(rprod, rsrc.name, RW) == got
        finally:
            rprod.close()
            rsrv.close()
            rfe.close()
            rsched.wal.close()
    finally:
        prod.close()
        srv.close()
        fe.close()
        sched.wal.close()


def test_same_request_same_frame_bytes(tmp_path, monkeypatch):
    """The frames a producer writes for the same session are the same
    bytes in both packages: the hello with its in-doubt ids, and each
    submit with its pickled host batch."""
    import reflow_tpu.net.transport as jtransport

    import reflow_tpu_torch.net.transport as ptransport

    frames = {"jax": [], "port": []}
    for pkg, mod in (("jax", jtransport), ("port", ptransport)):
        real = mod.encode_frame

        def rec(obj, _real=real, _out=frames[pkg]):
            data = _real(obj)
            if isinstance(obj, tuple) and obj and obj[0] in ("hello",
                                                              "submit"):
                _out.append(data)
            return data

        monkeypatch.setattr(mod, "encode_frame", rec)
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        sched, fe, srv, src, _sink, W = _stack(pkg, d)
        prod = _producer(pkg, srv.address)
        try:
            _session(prod, src.name, W)
        finally:
            prod.close()
            srv.close()
            fe.close()
            sched.wal.close()
    assert len(frames["port"]) == 5      # one hello, four submits
    assert frames["port"] == frames["jax"]


def test_device_batch_crosses_as_its_host_copy(tmp_path, kind):
    """A device batch submitted to a remote producer goes as its host
    copy (padding dropped) and folds like the host batch; a tensor on
    its own is refused by the framing."""
    from reflow_tpu_torch.net.framing import encode_frame

    sched, fe, lt, srv, src, sink = make_stack(tmp_path)
    prod = RemoteProducer(lt, srv.address, name="p0")
    try:
        host = batch("dv dv dw")
        # the oracle's string keys have no device form: it sends the host
        # batch itself
        payload = (to_device(host, src.spec, device="cpu")
                   if kind == "cuda" else host)
        assert prod.submit(src, payload, batch_id="d0").result(10).applied
        fe.flush()
        view = sched.view(sink.name)
        assert view[(key("dv"), 2.0)] == 1 and view[(key("dw"), 1.0)] == 1
    finally:
        prod.close()
        srv.close()
        fe.close()
        sched.wal.close()
    with pytest.raises(FrameError, match="wire"):
        encode_frame(("submit", "b", "lines", torch.zeros(3)))
