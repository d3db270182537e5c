"""World-parallel simulation and training across processes (port of
``gpudrive_lab_tpu/parallel/``): ``mesh`` holds the per-rank layout
(``WorldGroup``, ``shard_worlds``, ``replicate``), ``distributed`` the
process group's set-up and the host-side helpers, ``dryrun`` the check that
the sharded learners give one process's update, ``scaling`` the
world-steps/s at 1..n ranks.  Importing them starts no process group."""
