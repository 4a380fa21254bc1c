"""The port's launcher end to end on gloo ranks: the env contract it
writes against the JAX launcher's, port workers started by either
launcher (the rendezvous through the launcher's KV), and ``run(fn)``
with its HMAC-checked function and results.

Port workers under ``python -m horovod_tpu.run.runner`` (the JAX
launcher, unmodified) and under ``python -m horovod_tpu_torch.run`` take
3 ``DistributedOptimizer`` steps of the small transformer; the
parameters must match the JAX ``DistributedOptimizer`` under
``shard_map`` (``tests/test_torch_optimizer.py``'s oracle and tolerance,
rtol 1e-5 / atol 2e-6).  Before the port's rendezvous went through the
KV, rank 0 bound a ``TCPStore`` on the KV server's own port and died
with EADDRINUSE under the JAX launcher."""

import base64
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch_run_fns

from test_torch_optimizer import (LR, PER_RANK, RANKS, STEPS,  # noqa: F401
                                  jax_run)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
LAUNCHERS = {"jax": ["-m", "horovod_tpu.run.runner"],
             "port": ["-m", "horovod_tpu_torch.run"]}

ENV_DUMP = textwrap.dedent("""
    import json, os
    print("ENV " + json.dumps({k: v for k, v in os.environ.items()
                               if k.startswith("HVD_")}), flush=True)
""")

F1_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (Transformer, TransformerConfig,
                                          lm_loss)
    from horovod_tpu_torch.parallel.ring_attention import reference_attention

    data_path, out_dir = sys.argv[1:3]
    cfg = dict(vocab_size=512, n_layers=2, d_model=64, n_heads=4, d_ff=128,
               max_len=32, attn_fn=reference_attention)
    data = np.load(data_path)
    hvd.init(device="cpu")   # the launcher's contract, no store_path
    try:
        r = hvd.rank()
        total = hvd.allreduce(torch.full((3,), float(r + 1)), op=hvd.Sum)
        assert torch.equal(total, torch.full((3,), 3.0)), total
        model = Transformer(TransformerConfig(**cfg, dtype=torch.float32),
                            device="cpu", seed=r)
        model.load_state_dict({k[2:]: torch.from_numpy(data[k])
                               for k in data.files if k.startswith("p.")})
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=float(data["lr"]),
                              weight_decay=1e-4),
            named_parameters=model.named_parameters())
        n = int(data["per_rank"])
        tokens = torch.from_numpy(data["tokens"][r * n:(r + 1) * n]).long()
        out = {}
        for step in range(int(data["steps"])):
            opt.zero_grad()
            lm_loss(model(tokens), tokens).backward()
            opt.step()
            for k, v in model.state_dict().items():
                out[f"{step}.{k}"] = v.numpy().copy()
        np.savez(f"{out_dir}/out{r}.npz", **out)
    finally:
        hvd.shutdown()
""")


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))


def _launch(launchers, np_total, command, logs, timeout=120):
    """Run ``command`` under each of ``launchers`` at once, the rank logs
    of each under ``logs / launcher``."""
    procs = [subprocess.Popen(
        [sys.executable, *LAUNCHERS[launcher], "-np", str(np_total),
         "--output-filename", str(logs / launcher), *command],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for launcher in launchers]
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=timeout)
            assert proc.returncode == 0, out
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.mark.parametrize("np_total", [1, 2])
def test_env_contract_matches_the_jax_launcher(tmp_path, np_total):
    """Both launchers give every rank the same HVD_* variables, apart from
    the rendezvous port and the job key (a fresh one each job)."""
    script = tmp_path / "env_dump.py"
    script.write_text(ENV_DUMP)
    _launch(LAUNCHERS, np_total, [sys.executable, str(script)], tmp_path)
    seen = {}
    for launcher in LAUNCHERS:
        seen[launcher] = []
        for r in range(np_total):
            text = (tmp_path / launcher / f"rank.{r}" / "stdout").read_text()
            env = json.loads(text.split("ENV ", 1)[1])
            assert len(base64.b64decode(env.pop("HVD_SECRET_KEY"))) == 32
            assert int(env.pop("HVD_RENDEZVOUS_PORT")) > 0
            seen[launcher].append(env)
    assert seen["port"] == seen["jax"]
    assert [e["HVD_RANK"] for e in seen["port"]] == [
        str(r) for r in range(np_total)]


@pytest.mark.parametrize("launcher", sorted(LAUNCHERS))
def test_port_workers_train_under_each_launcher(tmp_path, launcher,
                                                jax_run):
    """F1 (ROADMAP C.13): port workers rendezvous through the launcher's
    KV (rank 0 publishes its store), allreduce, and take 3
    ``DistributedOptimizer`` steps that match the JAX oracle."""
    flat, tokens, want = jax_run
    np.savez(tmp_path / "data.npz", tokens=tokens, lr=LR, steps=STEPS,
             per_rank=PER_RANK, **{f"p.{k}": v for k, v in flat.items()})
    script = tmp_path / "worker.py"
    script.write_text(F1_WORKER)
    _launch([launcher], RANKS, [sys.executable, str(script),
                                str(tmp_path / "data.npz"), str(tmp_path)],
            tmp_path)
    ranks = [np.load(tmp_path / f"out{r}.npz") for r in range(RANKS)]
    for step in range(STEPS):
        for name, value in want[step].items():
            got = [r[f"{step}.{name}"] for r in ranks]
            np.testing.assert_array_equal(got[0], got[1],
                                          err_msg=f"ranks differ: {name}")
            np.testing.assert_allclose(got[0], value, rtol=1e-5, atol=2e-6,
                                       err_msg=f"step {step} {name}")


# ------------------------------------------------------------- run(fn) ---
# the workers import torch_run_fns (beside this file) to load the function
RUN_ENV = {"PYTHONPATH": os.pathsep.join([TESTS, REPO, os.environ.get(
    "PYTHONPATH", "")]), "OMP_NUM_THREADS": "1"}


@pytest.mark.parametrize("np_total", [1, 2])
def test_run_fn_returns_rank_ordered_results(np_total):
    from horovod_tpu_torch.run import run

    got = run(torch_run_fns.allreduce_fn, args=(2.0,), np=np_total,
              extra_env=RUN_ENV)
    total = 2.0 * np_total * (np_total + 1) / 2
    assert got == [(r, [total] * 3) for r in range(np_total)]


def test_run_fn_refuses_a_result_with_a_wrong_digest(monkeypatch):
    """A result whose digest does not verify raises PermissionError
    before it is unpickled."""
    from horovod_tpu_torch.run import api

    class Tampered(api.RendezvousServer):
        def get(self, scope, key):
            blob = super().get(scope, key)
            if scope == api.RESULT_SCOPE and key == "1":
                blob = blob[:-1] + bytes([blob[-1] ^ 1])
            return blob

    monkeypatch.setattr(api, "RendezvousServer", Tampered)
    with pytest.raises(PermissionError, match="rank 1 result failed HMAC"):
        api.run(torch_run_fns.rank_fn, np=2, extra_env=RUN_ENV)


def test_run_fn_reports_a_failing_rank():
    from horovod_tpu_torch.run import run

    with pytest.raises(RuntimeError, match="exit code 1"):
        run(torch_run_fns.failing_fn, np=2, extra_env=RUN_ENV)


def test_task_runner_checks_the_function_before_loading_it(tmp_path):
    """A function blob signed with another key: the worker unpickles
    nothing, posts a signed error and exits 1."""
    from horovod_tpu_torch.run import api
    from horovod_tpu_torch.run.http_server import RendezvousServer
    from horovod_tpu_torch.run.service import secret

    tripwire = tmp_path / "tripped"
    forged = pickle.dumps((open, (str(tripwire), "w"), {}))
    key = secret.make_secret_key()
    server = RendezvousServer()
    port = server.start()
    try:
        with server._server.kv_lock:
            server._server.kv[api.FN_SCOPE] = {
                "fn": secret.sign(secret.make_secret_key(), forged) + forged}
        env = dict(_env(), HVD_RENDEZVOUS_ADDR="127.0.0.1",
                   HVD_RENDEZVOUS_PORT=str(port), HVD_RANK="0",
                   HVD_SECRET_KEY=base64.b64encode(key).decode())
        out = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.run.task_runner"],
            env=env, cwd=REPO, capture_output=True, text=True, timeout=60)
        assert out.returncode == 1, out.stdout + out.stderr
        blob = server.get(api.RESULT_SCOPE, "0")
    finally:
        server.stop()
    assert not tripwire.exists()
    digest, payload = blob[:secret.DIGEST_LEN], blob[secret.DIGEST_LEN:]
    assert secret.check(key, payload, digest)
    status, text = pickle.loads(payload)
    assert status == "error" and "HMAC verification" in text
