"""Launchers: the serving CLI (``python -m repro_torch.launch.serve``), the
training CLI (``python -m repro_torch.launch.train``), meshes and input
specs."""
