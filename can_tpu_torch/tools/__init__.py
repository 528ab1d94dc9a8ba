"""Command-line tools of the port (``python -m can_tpu_torch.tools.<name>``):
``prepare_data`` (density maps and the prepared store),
``plan_ablation`` (the batch planner's cost mode against legacy) and
``convert_vgg16`` (a torchvision VGG-16 state dict -> the frontend
``.npz``)."""
