# The paper's queueing-theoretic analysis and control of LLM inference
# serving, as ported from ``repro.core``:
#
#   distributions  output-token length distributions (+ clipped moments, order stats)
#   latency_model  S = a*n + c and H[b,l] = k1*b + k2 + (k3*b + k4)*l calibration
#   mg1            M/G/1 FCFS queueing delay with max-token clipping   (Eqs 1-5)
#   impatience     abandonment model: De Kok-Tijms + exact level crossing (6-9)
#   policy_opt     optimal n_max (V1/V2)                               (10-13)
#   bulk           dynamic / fixed / elastic batching bulk queues      (14-26),
#                  and the multi-bin, WAIT and SRPT envelopes
#   policies       every serving discipline, defined once for every layer
#   simulate       the NumPy event-loop oracle validating every formula (paper SV)
#   fastsim        the simulators on the card: kernels S1-S5, the fleet's
#                  backlog routing on kernel S6 and the memory-gated tandem on S7
#   memory         KV-memory budgets and the prefill/decode tandem (its oracle,
#                  admission and occupancy accounting)
#   predictors     length predictors (oracle / noise models / learned head /
#                  prompt features) driving SRPT ordering, multi-bin routing
#                  and least_work fleet dispatch
#   traffic        modulated (non-stationary) arrival processes as time warps
#   faults         replica crash / slowdown / drop models, masked routing and
#                  the fault-injected fleet simulation
#   fleet          routing across parallel batched replicas (router registry,
#                  M/G/R transfer, QNA split approximation)
#   control        adaptive control plane wiring analytics into the engine
#   shardsweep     the grid sweeps with their lanes split over a "cells"
#                  mesh of devices
