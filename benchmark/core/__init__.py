"""The benchmark's harness: what a run does, apart from the program under
test (``fastga_tpu_torch``), the configurations, the traffic mixes, the
metric readers and the reference, which live beside it."""
