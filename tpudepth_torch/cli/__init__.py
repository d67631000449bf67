"""Command lines of the port, the counterparts of the JAX package's root
scripts, each run as ``python -m tpudepth_torch.cli.<name>``:

- ``guidedepth_main``: the GuideDepth stack (``guidedepth_main.py``):
  ``--train`` runs ``Trainer.fit`` with per-epoch checkpoints, ``--eval``
  the ``AlhashimEvaluator`` and ``results.txt``;
- ``train``: the root stack's trainer (``train.py``), rolling checkpoint and
  TensorBoard scalars and image grids under the reference's tags;
- ``test``: ``RootEvaluator`` on a checkpoint the port wrote (``test.py``);
- ``demo``: one image in, a colorized depth PNG out (``demo.py``).

The served speedtest and its ``--eval`` stay in ``tpudepth_torch/
inference.py``. Every command line takes ``--device`` (default ``cuda``,
which raises without a card) and ``main(argv)`` returns what it computed.
"""
