"""The port's gang dispatch protocol (kubeai_tpu_torch/engine/gang.py and
Engine.run_follower), the cases of the JAX package's
tests/test_gang_protocol.py: a rank-0 engine publishes over the real TCP
wire to a follower engine replaying in a thread (no tensor parallelism
here: the protocol alone), so identical op streams on identical weights
must leave the follower's device state bit-identical to rank 0's. Also
the codec's bytes against the JAX package's, the HTTP round trip of
tests/test_e2e_gang.py, and a re-form after a gang.follower failpoint."""

import json
import socket
import struct
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from _torch_threads import few_torch_threads  # noqa: F401
from kubeai_tpu.engine import gang as jgang
from kubeai_tpu_torch import faults as tfaults
from kubeai_tpu_torch.engine import core as tcore
from kubeai_tpu_torch.engine.gang import (
    _TAG_FOLLOWER,
    GangFollower,
    GangPublisher,
    _decode,
    _encode,
    _mac,
)
from kubeai_tpu_torch.engine.lora import write_peft_checkpoint
from kubeai_tpu_torch.engine.sampling import SamplingParams
from kubeai_tpu_torch.engine.server import EngineServer

SECRET = "test-gang-secret"
EC = dict(max_slots=4, max_seq_len=256, prefill_buckets=(16, 32, 64, 128))


def connect_pair(pub, timeout=10, secret=SECRET, rank=1):
    """Connect a follower in a thread while the publisher accepts (the
    handshake needs both sides live)."""
    out = {}

    def _connect():
        try:
            out["fol"] = GangFollower("127.0.0.1", pub.port, timeout=timeout, secret=secret,
                                      rank=rank)
        except Exception as e:
            out["err"] = e

    t = threading.Thread(target=_connect, daemon=True)
    t.start()
    pub.accept_all(timeout=timeout)
    t.join(timeout=timeout)
    if "err" in out:
        raise out["err"]
    return out["fol"]


def _leader_and_follower(decode_kernel="ragged"):
    follower = tcore.build_test_engine(device="cpu")
    pub = GangPublisher(1, port=0, host="127.0.0.1", secret=SECRET)
    fol = connect_pair(pub)
    leader = tcore.Engine(follower.model_config, follower.params, follower.tokenizer,
                          tcore.EngineConfig(**EC, decode_kernel=decode_kernel), device="cpu",
                          publisher=pub)
    t = threading.Thread(target=follower.run_follower, args=(fol,), daemon=True)
    t.start()
    return leader, follower, t


@pytest.fixture()
def pair():
    leader, follower, t = _leader_and_follower()
    leader.start()
    yield leader, follower, t
    leader.stop()  # publisher.close() sends "stop"
    t.join(timeout=20)
    assert not t.is_alive(), "follower loop did not exit on stop"


STATE = ("_lengths", "_last", "_seeds", "_tok_hist", "_adm_toks")


def _sync(leader, follower, names=STATE, timeout=30):
    """Wait until the follower's device state equals the leader's (its
    replay runs on its own thread), then assert it, pool included."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        # The pool too: the follower's last chunk may still be writing it
        # (the trash page) after its state already equals the leader's.
        if all(torch.equal(getattr(follower, n), getattr(leader, n)) for n in names) and \
                torch.equal(follower.cache["kv"], leader.cache["kv"]):
            break
        time.sleep(0.05)
    for n in names:
        assert torch.equal(getattr(follower, n), getattr(leader, n)), n
    assert torch.equal(follower.cache["kv"], leader.cache["kv"])


def test_codec_bytes_equal_the_jax_codec():
    arrays = {"table": np.arange(12, dtype=np.int32).reshape(3, 4),
              "active": np.array([True, False, True]), "temp": np.ones(3, np.float32),
              "bias": np.zeros((3, 2), np.int64)}
    scalars = {"decode_kernel": "dedicated", "seed": 7}
    blob = _encode("decode", scalars, arrays)
    assert blob == jgang._encode("decode", scalars, arrays)
    import io

    op, sc, ar = _decode(io.BytesIO(blob))
    assert op == "decode" and sc == scalars
    for k, v in arrays.items():
        assert ar[k].dtype == v.dtype and np.array_equal(ar[k], v)


def test_replay_produces_identical_device_state(pair):
    leader, follower, _ = pair
    ids, _, fin = leader.generate(list(range(1, 24)),
                                  SamplingParams(temperature=0.0, max_tokens=12), timeout=120)
    assert fin.completion_tokens >= 1
    _sync(leader, follower)
    assert follower.follower_ops["prefill_batch"] >= 1 and follower.follower_ops["decode"] >= 1


def test_chunked_prefill_replays(pair):
    leader, follower, _ = pair
    # Longer than the largest bucket: chunks of 128, the last samples.
    leader.generate([(i * 7) % 250 + 1 for i in range(200)],
                    SamplingParams(temperature=0.0, max_tokens=4), timeout=120)
    _sync(leader, follower)
    assert follower.follower_ops["prefill_chunk"] == 2


def test_embed_and_seeded_sampling_replay(pair):
    leader, follower, _ = pair
    vecs = leader.embed([[1, 2, 3], [9, 8, 7, 6]])
    assert vecs.shape[0] == 2
    leader.generate([5, 6, 7], SamplingParams(temperature=0.9, max_tokens=6, seed=11),
                    timeout=120)
    _sync(leader, follower)
    assert follower.follower_ops["embed"] == 1


def test_adapter_ops_replay(pair, tmp_path):
    leader, follower, _ = pair
    write_peft_checkpoint(str(tmp_path / "ad"), leader.model_config, seed=2)
    leader.load_adapter("wire-ad", str(tmp_path / "ad"))
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and follower.loaded_adapters() != ["wire-ad"]:
        time.sleep(0.05)
    assert follower.loaded_adapters() == ["wire-ad"]
    for name in leader._adapters.bank:
        assert torch.equal(follower._adapters.bank[name], leader._adapters.bank[name])
    leader.generate([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=4), timeout=120,
                    adapter="wire-ad")
    _sync(leader, follower)
    assert leader.unload_adapter("wire-ad") is True
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and follower.loaded_adapters():
        time.sleep(0.05)
    assert follower.loaded_adapters() == []


def test_reset_op_reinitializes_follower(pair):
    leader, follower, _ = pair
    leader.generate(list(range(1, 20)), SamplingParams(temperature=0.0, max_tokens=8),
                    timeout=120)
    _sync(leader, follower)
    assert follower._lengths.any()
    time.sleep(0.2)  # no publish in flight
    leader._publisher.publish("reset")
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and follower._lengths.any():
        time.sleep(0.05)
    assert not follower._lengths.any() and not follower.cache["kv"].any()


def test_penalized_and_biased_generation_replays(pair):
    leader, follower, _ = pair
    ids, _, fin = leader.generate(
        list(range(1, 20)),
        SamplingParams(temperature=0.0, max_tokens=10, presence_penalty=1.0,
                       frequency_penalty=1.5, logit_bias=((7, -100.0),)),
        timeout=120)
    assert fin.completion_tokens >= 1 and 7 not in ids
    _sync(leader, follower)


def test_decode_kernel_flag_rides_broadcast():
    """Rank 0's resolved decode kernel rides every decode broadcast, and
    a follower whose own config resolves another runs the broadcast one."""
    leader, follower, t = _leader_and_follower(decode_kernel="dedicated")
    seen: list[dict] = []
    real_publish = leader._publisher.publish

    def spying_publish(op, scalars=None, arrays=None):
        if op == "decode":
            seen.append(dict(scalars or {}))
        real_publish(op, scalars, arrays)

    leader._publisher.publish = spying_publish
    leader.start()
    try:
        _, _, fin = leader.generate(list(range(1, 20)),
                                    SamplingParams(temperature=0.0, max_tokens=6), timeout=120)
        assert fin.completion_tokens >= 1
        assert seen and all(sc.get("decode_kernel") == "dedicated" for sc in seen), seen
        _sync(leader, follower)
        assert follower.follower_kernels == {"dedicated"}
        assert follower.decode_kernel == "ragged"
    finally:
        leader.stop()
        t.join(timeout=20)
    assert not t.is_alive()


def test_follower_drop_reforms_the_gang_and_replays_adapters(pair, tmp_path):
    """A gang.follower failpoint drops the follower's stream: it
    reconnects with backoff, rank 0 goes not ready, fails the work in
    flight, re-forms the gang with a reset and the adapter loads
    (kubeai_gang_reforms_total), and serving resumes in lockstep."""
    leader, follower, _ = pair
    write_peft_checkpoint(str(tmp_path / "ad"), leader.model_config, seed=3)
    leader.load_adapter("ad", str(tmp_path / "ad"))
    reforms = leader.m_gang_reforms.value()
    tfaults.set_fault("gang.follower", "error", times=1)
    try:
        # The follower replays this request's first op, then its next recv
        # fails and it reconnects; the request may fail with the loss.
        try:
            leader.generate([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=3),
                            timeout=60)
        except RuntimeError as e:
            assert "gang" in str(e)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and follower.follower_reconnects < 1:
            time.sleep(0.05)
        assert follower.follower_reconnects == 1
        out = None
        while time.monotonic() < deadline and out is None:
            try:
                out = leader.generate([4, 5, 6], SamplingParams(temperature=0.0, max_tokens=4),
                                      timeout=60, adapter="ad")
            except RuntimeError as e:  # the request that found the gang degraded
                assert "gang" in str(e) or "not loaded" in str(e)
                time.sleep(0.1)
        assert out is not None and out[2].completion_tokens == 4
    finally:
        tfaults.clear_fault("gang.follower")
    assert leader.m_gang_reforms.value() == reforms + 1
    assert leader.is_ready() and follower.loaded_adapters() == ["ad"]
    _sync(leader, follower)


class TestHandshake:
    def test_wrong_secret_rejected_and_real_follower_still_joins(self):
        pub = GangPublisher(1, port=0, host="127.0.0.1", secret=SECRET)
        results = {}

        def imposter():
            try:
                GangFollower("127.0.0.1", pub.port, timeout=5, secret="wrong-secret", rank=1)
                results["imposter"] = "joined"
            except Exception as e:
                results["imposter"] = e

        t_imp = threading.Thread(target=imposter, daemon=True)
        t_imp.start()
        fol = connect_pair(pub, timeout=15)
        t_imp.join(timeout=30)
        assert not t_imp.is_alive() and results["imposter"] != "joined"
        assert len(pub._ranks) == 1 and 1 in pub._ranks
        fol.close()
        pub.close()

    def test_raw_tcp_connect_gets_no_dispatch_stream(self):
        pub = GangPublisher(1, port=0, host="127.0.0.1", secret=SECRET)
        eve = socket.create_connection(("127.0.0.1", pub.port), timeout=15)

        def eavesdrop():
            eve.recv(16)
            eve.sendall(b"\x00" * 52)  # rank + nonce + a bogus MAC

        t_eve = threading.Thread(target=eavesdrop, daemon=True)
        t_eve.start()
        fol = connect_pair(pub, timeout=15)
        t_eve.join(timeout=10)
        pub.publish("decode", {"x": 1}, {"a": np.arange(3, dtype=np.int32)})
        op, sc, _ = fol.recv()
        assert op == "decode" and sc == {"x": 1}
        eve.settimeout(5)
        assert eve.recv(4096) == b""
        eve.close()
        fol.close()
        pub.close()

    def test_duplicate_rank_rejected(self):
        pub = GangPublisher(2, port=0, host="127.0.0.1", secret=SECRET)

        def attempt(rank):
            s = socket.create_connection(("127.0.0.1", pub.port), timeout=10)
            s.settimeout(10)
            try:
                ch = s.recv(16)
                nonce = b"\x42" * 16
                s.sendall(struct.pack(">I", rank) + nonce
                          + _mac(SECRET.encode(), _TAG_FOLLOWER, ch + nonce, rank))
                try:
                    return s.recv(32), s
                except OSError:
                    return b"", s
            except OSError:
                return b"", s

        proof1, s1 = attempt(1)
        assert len(proof1) == 32
        deadline = time.monotonic() + 10
        while 1 not in pub._ranks and time.monotonic() < deadline:
            time.sleep(0.05)
        dup, s_dup = attempt(1)
        bad, s_bad = attempt(7)
        assert dup == b"" and bad == b""
        proof2, s2 = attempt(2)
        assert len(proof2) == 32
        pub.accept_all(timeout=10)
        assert set(pub._ranks) == {1, 2}
        for s in (s1, s_dup, s_bad, s2):
            s.close()
        pub.close()

    def test_accept_all_times_out(self):
        pub = GangPublisher(1, port=0, host="127.0.0.1", secret=SECRET)
        with pytest.raises(TimeoutError):
            pub.accept_all(timeout=1.0)
        pub.close()

    def test_missing_secret_is_an_error(self):
        with pytest.raises(ValueError):
            GangPublisher(1, port=0, host="127.0.0.1", secret="")
        with pytest.raises(ValueError):
            GangFollower("127.0.0.1", 1, timeout=1, secret="", rank=1)


class TestDesyncFatal:
    def test_post_broadcast_failure_terminates_rank(self, pair, monkeypatch):
        leader, _, _ = pair
        calls = {}

        def fake_terminate(message, code):
            calls["code"] = code
            leader._fail_inflight(message)
            leader._running = False

        monkeypatch.setattr(leader, "_terminate_rank", fake_terminate)
        leader.generate([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=2), timeout=120)

        def exploding(*a, **kw):
            raise RuntimeError("simulated rank-0-only dispatch failure")

        monkeypatch.setattr(leader, "_chunk_body", exploding)
        req = leader.submit([4, 5, 6], SamplingParams(temperature=0.0, max_tokens=4))
        ev = None
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            ev = req.out.get(timeout=10)
            if ev[0] in ("error", "done"):
                break
        assert ev is not None and ev[0] == "error", ev
        assert calls.get("code") == 14

    def test_single_host_failure_still_resets(self, monkeypatch):
        eng = tcore.build_test_engine(seed=7, device="cpu")
        eng.start()
        try:
            eng.generate([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=2), timeout=120)
            real = eng._chunk_body
            state = {"n": 0}

            def explode_once(*a, **kw):
                if state["n"] == 0:
                    state["n"] = 1
                    raise RuntimeError("transient device error")
                return real(*a, **kw)

            monkeypatch.setattr(eng, "_chunk_body", explode_once)
            req = eng.submit([4, 5], SamplingParams(temperature=0.0, max_tokens=3))
            assert req.out.get(timeout=60)[0] == "error"
            ids, _, _ = eng.generate([6, 7], SamplingParams(temperature=0.0, max_tokens=3),
                                     timeout=120)
            assert len(ids) == 3
        finally:
            eng.stop()


def test_rolled_back_rank_does_not_complete_assembly():
    pub = GangPublisher(2, port=0, host="127.0.0.1", secret=SECRET)
    real_send = pub._send_counter_proof
    fail_once = {"armed": True}

    def flaky_send(conn, transcript, rank):
        if rank == 1 and fail_once["armed"]:
            fail_once["armed"] = False
            raise OSError("injected proof-send failure")
        real_send(conn, transcript, rank)

    pub._send_counter_proof = flaky_send
    s = socket.create_connection(("127.0.0.1", pub.port), timeout=10)
    ch = s.recv(16)
    nonce = b"\x01" * 16
    s.sendall(struct.pack(">I", 1) + nonce + _mac(SECRET.encode(), _TAG_FOLLOWER, ch + nonce, 1))
    s.close()
    deadline = time.time() + 10
    while time.time() < deadline and (fail_once["armed"] or 1 in pub._ranks):
        time.sleep(0.05)
    assert 1 not in pub._ranks
    fol2 = GangFollower("127.0.0.1", pub.port, timeout=10, secret=SECRET, rank=2)
    assert not pub._assembled.is_set()
    fol1 = connect_pair(pub, timeout=15, rank=1)
    assert pub._assembled.wait(5)
    fol1.close()
    fol2.close()
    pub.close()


def test_gang_round_trips_completion_over_http():
    """The JAX package's in-process gang e2e against the port's server:
    rank 0 serves a seeded completion over HTTP while the follower
    replays the stream; seeded sampling reproduces; the follower's state
    converges; stop reaches the follower."""
    leader, follower, t = _leader_and_follower()
    reforms = leader.m_gang_reforms.value()  # the process's counter
    srv = EngineServer(leader, "gang-fast", host="127.0.0.1", port=0)
    srv.start()
    try:
        def complete():
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/completions",
                data=json.dumps({"model": "gang-fast", "prompt": "hello gang", "max_tokens": 8,
                                 "temperature": 0.7, "seed": 7}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                return json.loads(resp.read())

        body = complete()
        assert body["usage"]["completion_tokens"] >= 1
        assert complete()["choices"][0]["text"] == body["choices"][0]["text"]
        _sync(leader, follower)
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/debug/engine",
                                    timeout=30) as r:
            gang = json.loads(r.read())["gang"]
        assert gang["role"] == "leader" and gang["complete"] and gang["reforms"] == reforms
    finally:
        srv.stop()
        t.join(timeout=20)
    assert not t.is_alive(), "follower loop did not exit on stop"
