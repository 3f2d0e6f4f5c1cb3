"""Parallelism over ``torch.distributed``: the (data, model) mesh, data and
tensor parallelism (``mesh.py``) and ring attention (``ring_attention.py``)."""
