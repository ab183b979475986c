"""Counterpart of ``deeprecsys_tpu/parallel/``: so far only the training
losses (``sharding.py``); the sharded paths are ROADMAP.md Queue 1 item 12."""
