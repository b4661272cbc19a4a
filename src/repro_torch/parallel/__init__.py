"""Distribution over a mesh of `torch.distributed` ranks (`shard`)."""
