"""Command-line launchers of the port (`python -m repro_torch.launch.serve`,
`python -m repro_torch.launch.train`), the meshes and the card's constants
(`launch.mesh`) and the analytic cost model (`launch.roofline`)."""
