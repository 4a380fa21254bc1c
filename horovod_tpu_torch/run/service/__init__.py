"""The launcher's services: the job key (``secret``) and the transport
helpers the rendezvous uses (``network``)."""
