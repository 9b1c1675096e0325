"""The hand-written kernels' wrappers (``csrc/*.cu`` through ``_build``).
Each wrapper counts the launches of its kernel; ``zero_launches`` and
``read_launches`` set and read every count at once."""


def _wrappers() -> tuple:
    from kubeai_tpu_torch.ops.flash_attention import flash_attention
    from kubeai_tpu_torch.ops.paged_attention import paged_attention_ragged
    from kubeai_tpu_torch.ops.paged_decode_attention import paged_decode_attention
    from kubeai_tpu_torch.ops.quant import qdot, qdot_many

    return flash_attention, paged_attention_ragged, paged_decode_attention, qdot, qdot_many


def zero_launches() -> None:
    """Set every wrapper's launch counts to 0."""
    flash, ragged, dedicated, qdot, qdot_many = _wrappers()
    for fn in (flash, ragged, dedicated, qdot, qdot_many):
        fn.launches = 0
    for fn in (ragged, dedicated):
        fn.launches_by_pool.clear()
    ragged.launches_by_regime.clear()
    flash.launches_by_regime.clear()


def read_launches() -> dict:
    """{"launches": {wrapper: n}, "launches_by_pool": {paged wrapper:
    {pool dtype: n}}, "launches_by_regime": {ragged tile: n},
    "flash_launches_by_regime": {flash tile: n}}."""
    flash, ragged, dedicated, qdot, qdot_many = _wrappers()
    return {
        "launches": {fn.__name__: fn.launches for fn in (flash, ragged, dedicated, qdot,
                                                         qdot_many)},
        "launches_by_pool": {fn.__name__: dict(fn.launches_by_pool) for fn in (ragged, dedicated)},
        "launches_by_regime": dict(ragged.launches_by_regime),
        "flash_launches_by_regime": dict(flash.launches_by_regime),
    }
