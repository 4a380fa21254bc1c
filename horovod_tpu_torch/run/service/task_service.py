"""The task server of NIC discovery (port of
``horovod_tpu/run/service/task_service.py``; reference:
``horovod/run/task/task_service.py`` and ``task_fn.py``): one a host while
the launcher discovers its NICs; it registers with the driver, probes a
peer's addresses when the driver asks, and runs a command for the
driver."""

import subprocess
import threading

from horovod_tpu_torch.run.service import network


class ProbeAddressesRequest:
    def __init__(self, addresses):
        self.addresses = addresses  # {iface: [(ip, port)]}


class ProbeAddressesResponse:
    def __init__(self, reachable):
        self.reachable = reachable  # {iface: [(ip, port)]} subset


class RunCommandRequest:
    def __init__(self, command, env=None):
        self.command = command
        self.env = env


class CommandExitCodeRequest:
    pass


class CommandExitCodeResponse:
    def __init__(self, terminated, exit_code):
        self.terminated = terminated
        self.exit_code = exit_code


class ShutdownTaskRequest:
    pass


class TaskService(network.BasicService):
    NAME = "horovod_tpu_torch task service"

    def __init__(self, index, key):
        self.index = index
        self._command_proc = None
        self._command_exit = None
        self._lock = threading.Lock()
        self.shutdown_requested = threading.Event()
        super().__init__(f"{self.NAME} {index}", key)

    def _handle(self, req, client_address):
        if isinstance(req, ProbeAddressesRequest):
            # retry_for=0: a probe reports the unreachable addresses; a
            # backoff a dead NIC would make every sweep stall
            client = network.BasicClient(req.addresses, self._key,
                                         timeout=3, retry_for=0)
            good = set(client.probe())
            reachable = {
                iface: [a for a in addrs if a in good]
                for iface, addrs in req.addresses.items()}
            reachable = {i: a for i, a in reachable.items() if a}
            return ProbeAddressesResponse(reachable)
        if isinstance(req, RunCommandRequest):
            with self._lock:
                if self._command_proc is not None:
                    raise RuntimeError("a command is already running")
                self._command_exit = None
                self._command_proc = subprocess.Popen(
                    req.command, shell=True, env=req.env)

                def wait(proc=self._command_proc):
                    code = proc.wait()
                    with self._lock:
                        self._command_exit = code
                        self._command_proc = None

                # lifecycle: ends when the launched command exits and
                # its wait returns
                threading.Thread(target=wait, daemon=True).start()
            return network.AckResponse()
        if isinstance(req, CommandExitCodeRequest):
            with self._lock:
                return CommandExitCodeResponse(
                    self._command_exit is not None, self._command_exit)
        if isinstance(req, ShutdownTaskRequest):
            self.shutdown_requested.set()
            return network.AckResponse()
        return super()._handle(req, client_address)


class TaskClient(network.BasicClient):
    def probe_addresses(self, addresses):
        return self.send(ProbeAddressesRequest(addresses),
                         idempotent=True).reachable

    def run_command(self, command, env=None):
        # not idempotent: a replay would start the command twice, which
        # the service refuses; a failure past the write must surface
        self.send(RunCommandRequest(command, env))

    def command_exit_code(self):
        resp = self.send(CommandExitCodeRequest(), idempotent=True)
        return resp.exit_code if resp.terminated else None

    def shutdown_task(self):
        self.send(ShutdownTaskRequest(), idempotent=True)
