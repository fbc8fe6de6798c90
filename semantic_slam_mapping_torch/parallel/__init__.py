"""The multi-device paths over ``torch.distributed``.

Counterpart of ``semantic_slam_mapping_tpu/parallel/``. JAX runs one
controller over a mesh of devices; here each device is a process (a rank)
that runs the same program on the same, replicated inputs, computes its
own shard and meets the others in collectives over the mesh's data axis:
the window's frame pairs (``sharded_frontend``), the pose graph's edges
(``sharded_pcg``), the BoW database's rows (``sharded_bow``) and the map's
X slabs (``sharded_map``). ``mesh`` builds the (data, model) mesh and holds
the counted collectives they use.
"""
