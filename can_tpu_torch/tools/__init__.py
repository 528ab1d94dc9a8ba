"""Command-line tools of the port (``python -m can_tpu_torch.tools.<name>``):
``prepare_data`` (density maps and the prepared store) and
``plan_ablation`` (the batch planner's cost mode against legacy)."""
