"""Multi-device and multi-process execution (counterpart of
``memento_tpu/parallel/``): a mesh of devices in one process
(``mesh``, ``sharded``, ``streaming``) and processes joined by
``torch.distributed`` (``distributed``)."""
