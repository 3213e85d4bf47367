"""Multi-device paths: the process runtime (`distributed`) and the sharded
GMM association and local BA (`sharding`), over `torch.distributed`."""
