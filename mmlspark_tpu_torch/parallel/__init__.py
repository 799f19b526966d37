"""Process groups, device meshes and a rank launcher over
``torch.distributed`` (counterpart of ``mmlspark_tpu/parallel/``).

JAX runs a mesh as one program; the port runs one process per rank,
each holding its shard, with collectives between them. Nothing here
imports JAX.
"""
