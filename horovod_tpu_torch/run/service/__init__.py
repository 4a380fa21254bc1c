"""The launcher's services: the job key (``secret``) and the HMAC-framed
TCP transport of the control plane, with the helpers the rendezvous
uses (``network``)."""
