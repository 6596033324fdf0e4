"""repro_torch.launch — entry points of the port (``python -m
repro_torch.launch.{train,serve,dryrun}``), the meshes, and the dry run's
cell builders and cost walk."""
