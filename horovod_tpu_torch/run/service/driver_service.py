"""The launcher's driver service for NIC discovery (port of
``horovod_tpu/run/service/driver_service.py``; reference:
``horovod/run/driver/driver_service.py``): task servers register their
addresses with the driver; the driver asks each task to probe the next
task's addresses and intersects the interfaces that answered, which are
the NICs routable between every pair of hosts
(``driver_service.py:156,225``)."""

import threading

from horovod_tpu_torch.run.service import network


# ------------------------------------------------------------------ messages
class RegisterTaskRequest:
    def __init__(self, index, task_addresses, host_hash=None):
        self.index = index
        self.task_addresses = task_addresses  # {iface: [(ip, port)]}
        # the host's identity (run/host_hash.py): two tasks on one host
        # skip the probe, every interface of a host reaches itself
        self.host_hash = host_hash


class AllTaskAddressesRequest:
    def __init__(self, index):
        self.index = index


class AllTaskAddressesResponse:
    def __init__(self, all_task_addresses):
        self.all_task_addresses = all_task_addresses


class RegisterTaskToTaskAddressesRequest:
    def __init__(self, index, reachable_addresses):
        self.index = index
        self.reachable_addresses = reachable_addresses


class WaitDoneRequest:
    pass


class WaitDoneResponse:
    def __init__(self, done):
        self.done = done


# ------------------------------------------------------------------- service
class DriverService(network.BasicService):
    NAME = "horovod_tpu_torch driver service"

    def __init__(self, num_proc, key):
        self._num_proc = num_proc
        # index -> {iface: [(ip, port)]}; guarded by self._cv
        self._registered = {}
        self._host_hashes = {}         # index -> hash; guarded by self._cv
        # index -> {iface: [(ip, port)]}; guarded by self._cv
        self._task_to_task = {}
        self._cv = threading.Condition()
        super().__init__(self.NAME, key)

    def _handle(self, req, client_address):
        if isinstance(req, RegisterTaskRequest):
            with self._cv:
                self._registered[req.index] = req.task_addresses
                self._host_hashes[req.index] = req.host_hash
                self._cv.notify_all()
            return network.AckResponse()
        if isinstance(req, AllTaskAddressesRequest):
            with self._cv:
                return AllTaskAddressesResponse(
                    dict(self._registered)
                    if req.index < 0 else self._registered[req.index])
        if isinstance(req, RegisterTaskToTaskAddressesRequest):
            with self._cv:
                self._task_to_task[req.index] = req.reachable_addresses
                self._cv.notify_all()
            return network.AckResponse()
        if isinstance(req, WaitDoneRequest):
            with self._cv:
                return WaitDoneResponse(
                    len(self._task_to_task) == self._num_proc)
        return super()._handle(req, client_address)

    # ------------------------------------------------------------ driver side
    def wait_for_initial_registration(self, timeout=60):
        with self._cv:
            if not self._cv.wait_for(
                    lambda: len(self._registered) == self._num_proc,
                    timeout=timeout):
                missing = [i for i in range(self._num_proc)
                           if i not in self._registered]
                raise TimeoutError(
                    f"tasks {missing} did not register within {timeout}s")

    def task_addresses(self, index):
        with self._cv:
            return self._registered[index]

    def host_hash(self, index):
        with self._cv:
            return self._host_hashes.get(index)

    def common_interfaces(self):
        """The interfaces of each task that its predecessor reached; the
        job's usable NICs are their names' intersection (reference:
        ``_driver_fn``)."""
        with self._cv:
            iface_sets = [set(addrs.keys())
                          for addrs in self._task_to_task.values()]
        if not iface_sets:
            return set()
        common = set.intersection(*iface_sets)
        if not common:
            raise RuntimeError(
                "no network interface is routable between all hosts; "
                "set HVD_IFACE to force one")
        return common


class DriverClient(network.BasicClient):
    """Every driver request is idempotent (a registration overwrites the
    same value, the rest are reads), so the transport may replay one in
    full after a failure past its write."""

    def register_task(self, index, task_addresses, host_hash=None):
        self.send(RegisterTaskRequest(index, task_addresses, host_hash),
                  idempotent=True)

    def all_task_addresses(self, index=-1):
        return self.send(AllTaskAddressesRequest(index),
                         idempotent=True).all_task_addresses

    def register_task_to_task_addresses(self, index, reachable):
        self.send(RegisterTaskToTaskAddressesRequest(index, reachable),
                  idempotent=True)

    def wait_done(self):
        return self.send(WaitDoneRequest(), idempotent=True).done


def find_common_interfaces(driver, key, num_proc, timeout=60):
    """Once every task has registered, have task i probe task (i + 1) % n
    and intersect the interface names that answered (reference:
    ``driver_service.get_common_interfaces``, ``driver_service.py:225``)."""
    from horovod_tpu_torch.run.service.task_service import TaskClient

    driver.wait_for_initial_registration(timeout=timeout)
    for i in range(num_proc):
        nxt = (i + 1) % num_proc
        hh_i = driver.host_hash(i)
        if hh_i is not None and hh_i == driver.host_hash(nxt):
            # one host: every interface reaches itself, no probe
            reachable = driver.task_addresses(nxt)
        else:
            client = TaskClient(driver.task_addresses(i), key)
            reachable = client.probe_addresses(driver.task_addresses(nxt))
        driver._handle(
            RegisterTaskToTaskAddressesRequest(i, reachable), None)
    return driver.common_interfaces()
