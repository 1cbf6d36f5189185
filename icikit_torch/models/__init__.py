"""Workloads built on the ops and exchange layers."""
