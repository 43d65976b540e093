"""The port's command lines: `create_data`, `train`, `test`, each run as
`python -m pcdet_tpu_torch.tools.<name> ...` or called as `main(argv)`."""
