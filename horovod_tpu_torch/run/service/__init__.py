"""The launcher's services: the job key (``secret``), the HMAC-framed
TCP transport of the control plane with the helpers the rendezvous uses
(``network``), and NIC discovery's driver and task servers
(``driver_service``, ``task_service``, ``task_main``)."""
