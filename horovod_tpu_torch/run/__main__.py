"""``python -m horovod_tpu_torch.run``: the launcher CLI
(``run/runner.py``), as the ``hvdrun-torch`` console script."""

from horovod_tpu_torch.run.runner import main

if __name__ == "__main__":
    main()
