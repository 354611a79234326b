"""Checkpointing of the port: SepBIT log-structured blob store + atomic
manifests."""
from .ckpt import CheckpointManager
from .logstore import LogBlobStore, LogStoreConfig

__all__ = ["CheckpointManager", "LogBlobStore", "LogStoreConfig"]
