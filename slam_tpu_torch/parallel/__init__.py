"""Pipelined execution: the frontend streaming PNG sequences from disk
(decode, upload and compute overlapped), and multi-sequence runs."""
