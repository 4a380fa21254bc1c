"""The port's launcher (port of ``horovod_tpu/run``): ``hvdrun-torch`` /
``python -m horovod_tpu_torch.run`` (``runner.py``) and the programmatic
``run(fn)`` (``api.py``).

``run`` is imported on first use: the eager plane imports
``run.service.secret``, and a rank must not load the launcher with it."""


def __getattr__(name):
    if name == "run":
        from horovod_tpu_torch.run.api import run
        return run
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
