"""Launch layer of the PyTorch port: device meshes and the card's published
rates (``mesh``), the analytic roofline (``roofline``) and the training
entry point (``train``, ``python -m repro_torch.launch.train``)."""
