"""Corpus arrays and window sampling (copies of ``nylon_amt_tpu/data``)."""
