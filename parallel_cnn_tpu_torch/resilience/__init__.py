"""Fault tolerance of the port: the retry policy (serving), the health
sentinel, last-good rollback and the checkpoint ring, and preemption
signals (training), and the chaos harness's fault specs (``chaos``; the
serving faults are wired)."""
