"""Data parallelism and FSDP over processes (``podtpu/parallel/``):
``mesh.py`` (the group, the batch's rows, the collectives, FSDP2) and
``dryrun.py`` (a multi-process check of the train and eval steps)."""
