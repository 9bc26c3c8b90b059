"""One process per GPU over ``torch.distributed``: the port of
``resdepth_tpu/parallel`` (bootstrap, groups, all-reduces)."""
