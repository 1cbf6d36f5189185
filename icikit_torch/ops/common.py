"""Constants shared by the attention kernels and their plain versions
(a copy of ``icikit/ops/pallas_common.py``'s): the forward folds
log2(e) into the logit scale so its transcendental is exp2, and turns
the base-2 statistics back into nats with ln(2)."""

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
