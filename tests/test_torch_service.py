"""The port's NIC discovery (``run/service/{driver_service,task_service,
task_main}.py``, ``run/driver_discovery.py``) on the port's transport
(``run/service/network.py``): ``tests/test_service.py``'s registration
and discovery cases, the task servers as processes with the key on their
stdin, and the launcher's use of the result (``HVD_IFACE``)."""

import os
import subprocess
import sys
import threading
import time

import pytest

from horovod_tpu.run.service import driver_service as jax_driver
from horovod_tpu.run.service import secret as jax_secret
from horovod_tpu.run.service import task_service as jax_task
from horovod_tpu_torch.run import driver_discovery, runner
from horovod_tpu_torch.run.allocate import SlotInfo
from horovod_tpu_torch.run.service import driver_service as port_driver
from horovod_tpu_torch.run.service import network, secret
from horovod_tpu_torch.run.service import task_service as port_task
from horovod_tpu_torch.run.service.driver_service import (
    DriverClient, DriverService, find_common_interfaces)
from horovod_tpu_torch.run.service.task_service import (TaskClient,
                                                        TaskService)
from horovod_tpu_torch.utils import env as env_util


def _local(service):
    return {"lo0": [("127.0.0.1", service.port)]}


def _register(driver, tasks, key, addrs=None):
    def register(i):
        DriverClient(_local(driver), key).register_task(
            i, (addrs or {}).get(i, _local(tasks[i])))

    threads = [threading.Thread(target=register, args=(i,))
               for i in range(len(tasks))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


@pytest.mark.parametrize("n", [1, 2, 4])
def test_registration_and_nic_discovery(n):
    key = secret.make_secret_key()
    driver = DriverService(n, key)
    tasks = [TaskService(i, key) for i in range(n)]
    try:
        _register(driver, tasks, key)
        assert find_common_interfaces(driver, key, n, timeout=30) == {"lo0"}
        client = DriverClient(_local(driver), key)
        assert set(client.all_task_addresses()) == set(range(n))
        assert client.all_task_addresses(0) == _local(tasks[0])
        assert client.wait_done()
    finally:
        for t in tasks:
            t.shutdown()
        driver.shutdown()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_discovery_drops_an_unreachable_interface(package):
    """Task 1 also advertises an address nobody answers on: the probe
    drops it, and the common set is the JAX package's."""
    mods = {"jax": (jax_driver, jax_task, jax_secret),
            "port": (port_driver, port_task, secret)}
    drv_mod, task_mod, sec = mods[package]
    key = sec.make_secret_key()
    driver = drv_mod.DriverService(2, key)
    tasks = [task_mod.TaskService(i, key) for i in range(2)]
    try:
        client = drv_mod.DriverClient(_local(driver), key)
        client.register_task(0, _local(tasks[0]))
        client.register_task(1, {"lo0": [("127.0.0.1", tasks[1].port)],
                                 "bogus": [("10.255.255.1", 1)]})
        assert drv_mod.find_common_interfaces(driver, key, 2,
                                              timeout=60) == {"lo0"}
    finally:
        for t in tasks:
            t.shutdown()
        driver.shutdown()


def test_one_host_skips_the_probe():
    """Two tasks with one host hash reach each other without a probe,
    even on an address nobody answers on."""
    key = secret.make_secret_key()
    driver = DriverService(2, key)
    try:
        client = DriverClient(_local(driver), key)
        for i in range(2):
            client.register_task(i, {"eth9": [("10.255.255.1", 1)]},
                                 host_hash="h")
        assert find_common_interfaces(driver, key, 2, timeout=5) == {"eth9"}
    finally:
        driver.shutdown()


def test_no_common_interface_raises():
    key = secret.make_secret_key()
    driver = DriverService(2, key)
    try:
        for i, iface in enumerate(("a", "b")):
            driver._handle(port_driver.RegisterTaskToTaskAddressesRequest(
                i, {iface: [("127.0.0.1", 1)]}), None)
        with pytest.raises(RuntimeError, match="HVD_IFACE"):
            driver.common_interfaces()
    finally:
        driver.shutdown()


def test_wrong_key_is_refused_before_unpickling():
    key = secret.make_secret_key()
    driver = DriverService(1, key)
    try:
        stranger = DriverClient(_local(driver), secret.make_secret_key(),
                                retry_for=0)
        with pytest.raises((ConnectionError, OSError)):
            stranger.register_task(0, {"lo0": [("127.0.0.1", 1)]})
        with pytest.raises(TimeoutError):
            driver.wait_for_initial_registration(timeout=0.2)
    finally:
        driver.shutdown()


def test_timeout_lists_missing_tasks():
    key = secret.make_secret_key()
    driver = DriverService(3, key)
    try:
        DriverClient(_local(driver), key).register_task(
            1, {"lo0": [("127.0.0.1", 1)]})
        with pytest.raises(TimeoutError, match=r"\[0, 2\]"):
            driver.wait_for_initial_registration(timeout=0.2)
    finally:
        driver.shutdown()


def test_task_runs_a_command_and_reports_its_exit_code():
    key = secret.make_secret_key()
    task = TaskService(0, key)
    try:
        client = TaskClient(_local(task), key)
        client.run_command("exit 7")
        deadline = time.time() + 30
        code = None
        while code is None and time.time() < deadline:
            code = client.command_exit_code()
            time.sleep(0.05)
        assert code == 7
        client.shutdown_task()
        assert task.shutdown_requested.is_set()
    finally:
        task.shutdown()


def test_unknown_request_returns_the_error():
    key = secret.make_secret_key()
    task = TaskService(0, key)
    try:
        with pytest.raises(ValueError, match="unknown request"):
            TaskClient(_local(task), key).send(object())
    finally:
        task.shutdown()


def test_task_server_command_keeps_the_key_off_its_command_line():
    addrs = [("10.0.0.1", 4242), ("192.168.1.2", 4242)]
    local = driver_discovery._task_server_command(3, addrs)
    assert "horovod_tpu_torch.run.service.task_main" in local
    assert f"{env_util.HVD_TASK_INDEX}=3" in local
    assert "10.0.0.1:4242;192.168.1.2:4242" in local
    assert "HVD_SECRET_KEY" not in local and "ssh" not in local
    remote = driver_discovery._task_server_command(0, addrs, ssh_port=2222,
                                                   host="node7")
    assert remote.startswith("ssh -o StrictHostKeyChecking=no -p 2222 "
                             "node7 ")


def test_discovery_with_task_server_processes():
    """A whole round against task servers started as processes, which
    read the key from their stdin (the launcher starts them through ssh
    the same way)."""
    ifaces, ip = driver_discovery.discover_common_interfaces(
        ["localhost", "localhost"], timeout=60)
    assert ifaces <= set(network.local_interfaces())
    assert ip in network.local_interfaces().values()


def _slots(*hosts):
    return [SlotInfo(h, i, len(hosts), 0, 1, i, len(hosts))
            for i, h in enumerate(hosts)]


def test_maybe_discover_only_across_hosts(monkeypatch):
    calls = []
    monkeypatch.setattr(driver_discovery, "discover_common_interfaces",
                        lambda hosts, ssh_port=None: calls.append(
                            (hosts, ssh_port)) or ({"ib0"}, "10.1.1.1"))
    assert driver_discovery.maybe_discover(
        _slots("localhost", "127.0.0.1")) is None
    assert driver_discovery.maybe_discover(
        _slots("a", "b", "a"), ssh_port=22) == ({"ib0"}, "10.1.1.1")
    assert calls == [(["a", "b"], 22)]


def test_maybe_discover_falls_back_when_discovery_fails(monkeypatch):
    def fail(hosts, ssh_port=None):
        raise TimeoutError("tasks [1] did not register")

    monkeypatch.setattr(driver_discovery, "discover_common_interfaces",
                        fail)
    assert driver_discovery.maybe_discover(_slots("a", "b")) is None


@pytest.mark.parametrize("discovered", [({"ib0", "eth0"}, "10.1.1.1"),
                                        None])
def test_the_launcher_takes_the_discovered_nic(monkeypatch, discovered):
    """Across hosts the launcher's rendezvous address and the workers'
    HVD_IFACE come from discovery, else from the host name."""
    seen = {}
    monkeypatch.delenv(env_util.HVD_RENDEZVOUS_HOST_ADDR, raising=False)
    monkeypatch.setattr(
        "horovod_tpu_torch.run.ssh_check.check_all_hosts_ssh_successful",
        lambda hosts, ssh_port=None: None)
    monkeypatch.setattr(driver_discovery, "maybe_discover",
                        lambda slots, ssh_port=None: discovered)
    monkeypatch.setattr(runner, "_routable_addr", lambda slots: "192.0.2.9")

    def launch(slots, command, addr, port, extra_env=None, **kw):
        seen.update(addr=addr, env=extra_env)
        return 0

    monkeypatch.setattr(runner, "launch_job", launch)
    assert runner.run_commandline(
        ["-np", "2", "-H", "hosta:1,hostb:1", "true"]) == 0
    if discovered:
        assert seen["addr"] == "10.1.1.1"
        assert seen["env"][env_util.HVD_IFACE] == "eth0"
    else:
        assert seen["addr"] == "192.0.2.9"
        assert env_util.HVD_IFACE not in seen["env"]


def test_the_task_server_refuses_a_missing_key():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if not k.startswith("HVD_")}
    env.update({"PYTHONPATH": repo, env_util.HVD_TASK_INDEX: "0",
                env_util.HVD_DRIVER_ADDRS: "127.0.0.1:1"})
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run.service.task_main"],
        input="\n", env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1
    assert "no secret on stdin" in out.stderr
