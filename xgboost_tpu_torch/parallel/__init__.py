"""Distributed training: the host communicators (``collective``), their
resilient wrapper and fault injection (``resilience``), sharded
ingestion and ``train_per_host`` over ``torch.distributed``
(``launch``) and the rendezvous endpoint (``tracker``). The data mesh
itself is ``context.Mesh``; column split and the federated communicator
are ROADMAP A.8."""
