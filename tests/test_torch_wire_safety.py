"""Verify, then deserialize: the port unpickles bytes from other ranks
only after their HMAC digest, made with the job key, checks out (the
reference's rule, ``horovod_tpu/run/service/network.py``;
``bin/hvd-lint``'s wire-safety checker).

- ``bin/hvd-lint horovod_tpu_torch/``, unmodified, reports no finding;
- a rank whose ``HVD_SECRET_KEY`` differs has its frames refused by the
  coordinator, which fails the eager plane's cycle, and with it
  ``broadcast_object``, on its peers with the HMAC error naming it; the
  rank itself fails to verify the coordinator's frames and names rank
  0; nothing is unpickled;
- ``broadcast_object`` signed with another key fails on the receivers,
  and so does ``broadcast_optimizer_state``, whose layout it carries;
- ``hvd.init`` refuses a non-loopback rendezvous without a key."""

import base64
import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import dataclasses, json, os, sys
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics

    case, store, out_dir = sys.argv[1:4]


    def trip(out_dir):
        # runs only if a rank unpickles the object below
        open(os.path.join(out_dir, "tripped." + os.environ["HVD_RANK"]),
             "w").close()
        return "unpickled"


    class Tripwire:
        def __reduce__(self):
            return trip, (out_dir,)


    hvd.init(device="cpu", store_path=store)
    r = hvd.rank()
    if case in ("payload", "optimizer") and r == 0:
        # the root signs with another key than the one its peers check
        basics._state = dataclasses.replace(basics._state, key=b"k" * 32)
    try:
        if case == "optimizer":
            import torch
            opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(3))],
                                  lr=0.1)
            if r == 0:
                # a hyperparameter travels in the root's layout
                opt.param_groups[0]["trip"] = Tripwire()
            hvd.broadcast_optimizer_state(opt, root_rank=0)
            result = {"ok": "synced"}
        else:
            got = hvd.broadcast_object(Tripwire(), root_rank=0, name="wire")
            result = {"ok": got}
    except Exception as exc:  # the failure is the result
        result = {"error": f"{type(exc).__name__}: {exc}"}
    hvd.shutdown()
    print("RESULT " + json.dumps(result), flush=True)
""")


def test_hvd_lint_reports_no_finding_over_the_port():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bin", "hvd-lint"),
         "horovod_tpu_torch/"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s), 0 baselined" in out.stdout + out.stderr


def _key(seed):
    return base64.b64encode(bytes([seed]) * 32).decode()


def _run(tmp_path, case, keys):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = []
    try:
        for r, key in enumerate(keys):
            env = dict(os.environ, HVD_RANK=str(r), HVD_SIZE=str(len(keys)),
                       HVD_SECRET_KEY=key, OMP_NUM_THREADS="1",
                       PYTHONPATH=REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            procs.append(subprocess.Popen(
                [sys.executable, str(script), case, str(tmp_path / "store"),
                 str(tmp_path)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        results.append(json.loads(out.split("RESULT ", 1)[1]))
    return results


def test_a_rank_with_another_key_fails_the_cycle_on_its_peers(tmp_path):
    """Rank 1's ``HVD_SECRET_KEY`` differs: the coordinator (rank 0)
    refuses its frames, and the first cycle fails on both ranks, each
    naming the other, before anything is unpickled; so does the
    ``broadcast_object`` that waited on it."""
    results = _run(tmp_path, "cycle", [_key(1), _key(2)])
    for res in results:
        assert "error" in res, res
    assert ("the frames of rank 1 failed HMAC verification at the "
            "coordinator (rank 0)" in results[0]["error"]), results
    assert ("the frames of the coordinator (rank 0) failed HMAC "
            "verification on rank 1" in results[1]["error"]), results
    assert not list(tmp_path.glob("tripped.*"))


def test_broadcast_object_signed_with_another_key_fails_on_receivers(
        tmp_path):
    """The plane's key agrees but the root signs the object with another:
    the receiver refuses it unread; the root reads back its own."""
    results = _run(tmp_path, "payload", [_key(3), _key(3)])
    assert results[0] == {"ok": "unpickled"}
    assert results[1]["error"].startswith(
        "PermissionError: broadcast_object 'wire' from root rank 0 failed "
        "HMAC verification on rank 1"), results
    assert [p.name for p in tmp_path.glob("tripped.*")] == ["tripped.0"]


def test_broadcast_optimizer_state_signed_with_another_key_fails_on_receivers(
        tmp_path):
    """The optimizer state's layout travels signed too: a root with
    another key makes ``broadcast_optimizer_state`` fail on the receivers
    with nothing unpickled there."""
    results = _run(tmp_path, "optimizer", [_key(5), _key(5)])
    assert results[0] == {"ok": "synced"}
    assert results[1]["error"].startswith(
        "PermissionError: broadcast_object 'broadcast_optimizer_state."
        "layout' from root rank 0 failed HMAC verification on rank 1"), \
        results
    assert [p.name for p in tmp_path.glob("tripped.*")] == ["tripped.0"]


def test_same_key_broadcasts(tmp_path):
    results = _run(tmp_path, "same", [_key(4), _key(4)])
    assert results == [{"ok": "unpickled"}] * 2
    assert sorted(p.name for p in tmp_path.glob("tripped.*")) == [
        "tripped.0", "tripped.1"]


@pytest.fixture
def clean_env(monkeypatch):
    for key in list(os.environ):
        if key.startswith("HVD_"):
            monkeypatch.delenv(key)
    return monkeypatch


def test_init_refuses_a_non_loopback_rendezvous_without_a_key(clean_env):
    import horovod_tpu_torch as hvd

    clean_env.setenv("HVD_RANK", "0")
    clean_env.setenv("HVD_SIZE", "2")
    clean_env.setenv("HVD_RENDEZVOUS_ADDR", "10.1.2.3")
    clean_env.setenv("HVD_RENDEZVOUS_PORT", "4242")
    with pytest.raises(RuntimeError, match="HVD_SECRET_KEY is not set"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


def test_job_key_rule(clean_env, tmp_path):
    from horovod_tpu_torch.common.basics import job_key

    local = job_key()
    assert len(local) == 32 and local == job_key()
    assert job_key(store_path=tmp_path / "s") != local
    assert job_key(store_path=tmp_path / "s") == job_key(
        store_path=tmp_path / "s")
    clean_env.setenv("HVD_RENDEZVOUS_ADDR", "127.0.0.1")
    clean_env.setenv("HVD_RENDEZVOUS_PORT", "5000")
    loopback = job_key(size=2)
    clean_env.setenv("HVD_RENDEZVOUS_PORT", "5001")
    assert job_key(size=2) != loopback
    clean_env.setenv("HVD_RENDEZVOUS_ADDR", "10.1.2.3")
    with pytest.raises(RuntimeError, match="HVD_SECRET_KEY"):
        job_key(size=2)
    assert len(job_key(size=1)) == 32      # no peer to forge for
    assert len(job_key(store_path=tmp_path / "s", size=2)) == 32
    clean_env.setenv("HVD_SECRET_KEY", _key(7))
    assert job_key(size=2) == bytes([7]) * 32
    clean_env.setenv("HVD_SECRET_KEY", "not base64!")
    with pytest.raises(ValueError, match="HVD_SECRET_KEY is not base64"):
        job_key(size=2)
