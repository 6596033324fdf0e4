"""The plain float32 reference: forward passes and training steps in plain
PyTorch, importing nothing of the program.

Each configuration file names the module that speaks for its architecture
with ``"reference": "<stem>"``, which is ``reference/<stem>.py`` of the
benchmark root it was read from (``harness.architecture``); without the
key it is ``model`` (qwen3 and jamba).  A new architecture joins as a new
module beside it.  An architecture module provides:

* ``layer_kinds(conf)``: the (mixer, ffn) of each layer, from the
  published keys, and ``period(conf)``: the shortest run of them the
  stack repeats (the program's weight tree holds layer ``i`` at index
  ``i // period`` of group entry ``l{i % period}``);
* ``Reference(conf, params, fp8=False)``: the architecture over the weight
  tree ``params``, with ``hidden(tokens, cap_len=None)`` -> (final-normed
  hidden, load-balance loss, router z loss), ``logits(h)``, and where the
  module supports training ``loss(tokens, targets)``; ``fp8=True`` is the
  float8 control;
* ``check_program(conf, cfg)``: raises ``ValueError`` where the program's
  ``ModelConfig`` would run something other than what the file states
  (the harness has already held the generic published keys and the
  dtype to it);
* ``prefill_flops(conf, prompt_len)`` and ``train_flops_per_token(conf,
  seq_len)``: the model FLOPs the per-layer metrics divide by
  (``flops.py`` answers through them).

The shared helpers (``float32_matmuls``, ``token_gap``, ``flatten``,
``unflatten``, ``rms_norm``, ``rope``, ``fp8_round``) are imported from
``portbench.reference.model``; ``train`` takes ``Reference`` from the
configuration's module.
"""
