"""igaming_platform_tpu_torch: the risk scoring engine in PyTorch, for an NVIDIA H100.

A port of ``igaming_platform_tpu`` (JAX/XLA/Pallas on a TPU), built slice by
slice beside it. It mirrors the JAX package's subpackages, so each ported
module has one counterpart with the same name:

- ``core``    the 30-dim feature schema, enums, config, device selection;
- ``models``  rules, mock scorer, MLP, multi-task net, oblivious forest,
              the ensemble step and the abuse sequence transformer;
- ``ops``     the hand-written CUDA kernels (sources in ``csrc/``), their
              wrappers, plain PyTorch versions and the nvcc build;
- ``serve``   feature store, continuous batcher and the scoring engine,
              the event bridge and the bonus-abuse detector;
- ``train``   the bonus-abuse detector's trainer.

``convert.from_jax_params`` carries the JAX package's params across. The
package imports torch and numpy, never JAX and nothing of the JAX package.
Entry points run on ``device="cuda"`` unless the caller passes ``"cpu"``.
"""
