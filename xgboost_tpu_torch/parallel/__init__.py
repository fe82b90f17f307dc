"""Distributed training: the host communicators (``collective``), their
resilient wrapper and fault injection (``resilience``), sharded
ingestion and ``train_per_host`` over ``torch.distributed``
(``launch``), the rendezvous endpoint (``tracker``), the gRPC federated
communicator of vertical parties (``federated``) and its restricted
codec (``wire``). The data mesh itself is ``context.Mesh``."""
