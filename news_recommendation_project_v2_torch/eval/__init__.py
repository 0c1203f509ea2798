"""Evaluation: the MIND metrics on the host (``metrics``) and on the device
(``device_metrics``), and score composition (``ranker``)."""
