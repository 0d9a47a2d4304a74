"""CLI entry points of the PyTorch port, mirroring the reference scripts
(each also has a JAX twin under tpumil.cli):

  python -m tpumil_torch.cli.train_mil      <->  train_mil.py
  python -m tpumil_torch.cli.train_wsi      <->  train_tcga.py
  python -m tpumil_torch.cli.compute_feats  <->  compute_feats.py
  python -m tpumil_torch.cli.tiler          <->  deepzoom_tiler.py
  python -m tpumil_torch.cli.simclr_train   <->  simclr/run.py
  python -m tpumil_torch.cli.attention_map  <->  attention_map.py
  python -m tpumil_torch.cli.testing_tcga   <->  testing_tcga.py
  python -m tpumil_torch.cli.testing_c16    <->  testing_c16.py
  python -m tpumil_torch.cli.crop_single    <->  test_crop_single.py
  python -m tpumil_torch.cli.download       <->  download.py

Additions with no reference counterpart:

  python -m tpumil_torch.cli.pipeline       — 5-stage end-to-end run (YAML config)
  python -m tpumil_torch.cli.slide_feats    — streaming slide->features (no JPEG round trip)
  python -m tpumil_torch.cli.serve          — HTTP inference server (micro-batched embed/predict)

Every entry point that runs a model takes --device cuda|cpu (default cuda,
which raises without a card); tiler, crop_single and download run on the
host only.
"""
