from onet_tpu_torch.serve.tiles import infer_tiled  # noqa: F401
