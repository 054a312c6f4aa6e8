"""Predictor base class and the AES input wrapper, as
``moose_tpu/predictors/predictor.py``, with its serving hook
``traced_predictor``."""

import abc
import dataclasses

import moose_tpu_torch as pm

from . import predictor_utils as utils


@dataclasses.dataclass(frozen=True)
class PlacementContext:
    """The standard 3-party layout every predictor computes under: three
    named hosts, one replicated placement for the secret-shared compute,
    one mirrored placement for public model constants."""

    players: tuple
    replicated: object
    mirrored: object

    @classmethod
    def standard(cls) -> "PlacementContext":
        players = tuple(
            pm.host_placement(name) for name in ("alice", "bob", "carole")
        )
        return cls(
            players=players,
            replicated=pm.replicated_placement(
                name="replicated", players=list(players)
            ),
            mirrored=pm.mirrored_placement(
                name="mirrored", players=list(players)
            ),
        )


class Predictor(metaclass=abc.ABCMeta):
    """Base class for the predictor interface."""

    def __init__(self):
        ctx = PlacementContext.standard()
        self._ctx = ctx
        self.alice, self.bob, self.carole = ctx.players
        self.replicated = ctx.replicated
        self.mirrored = ctx.mirrored
        # (factory kind, fixedpoint dtype) -> the SAME computation object,
        # so runtimes hit their trace caches instead of re-tracing
        self._factory_cache = {}

    @property
    def host_placements(self):
        return self._ctx.players

    @classmethod
    def fixedpoint_constant(cls, x, plc=None, dtype=utils.DEFAULT_FIXED_DTYPE):
        """Embed a constant and cast it to the working fixed-point dtype."""
        return pm.cast(
            pm.constant(x, dtype=pm.float64, placement=plc),
            dtype=dtype,
            placement=plc,
        )

    @classmethod
    def handle_output(
        cls, prediction, prediction_handler,
        output_dtype=utils.DEFAULT_FLOAT_DTYPE,
    ):
        """Pin a value to an output placement, casting to a plaintext dtype."""
        with prediction_handler:
            return pm.cast(prediction, dtype=output_dtype)

    def _memoized(self, key, build):
        value = self._factory_cache.get(key)
        if value is None:
            value = self._factory_cache[key] = build()
        return value

    def predictor_factory(self, fixedpoint_dtype=utils.DEFAULT_FIXED_DTYPE):
        """Standard plaintext-input computation: alice supplies x, bob
        receives the prediction; the model itself runs replicated."""

        def build():
            @pm.computation
            def predictor(x: pm.Argument(self.alice, dtype=pm.float64)):
                with self.alice:
                    x_fixed = pm.cast(x, dtype=fixedpoint_dtype)
                with self.replicated:
                    y = self(x_fixed, fixedpoint_dtype)
                return self.handle_output(y, prediction_handler=self.bob)

            return predictor

        return self._memoized(("plain", fixedpoint_dtype), build)

    def traced_predictor(self, fixedpoint_dtype=utils.DEFAULT_FIXED_DTYPE):
        """The traced logical computation of :meth:`predictor_factory`,
        memoized beside it: the serving registry traces once per
        (instance, dtype) and every runtime and bucket reuses the same
        Computation object."""

        def build():
            from ..edsl import tracer

            return tracer.trace(self.predictor_factory(fixedpoint_dtype))

        return self._memoized(("traced", fixedpoint_dtype), build)


class AesInputMixin:
    """Encrypted-input front end: the client uploads an AES-GCM
    ciphertext, the key is secret-shared on the replicated placement, and
    decryption happens under MPC (the plaintext never exists on any one
    machine).  Composed onto a concrete predictor class by
    :func:`AesWrapper`."""

    def __call__(self, fixedpoint_dtype=utils.DEFAULT_FIXED_DTYPE):
        return self.aes_predictor_factory(fixedpoint_dtype)

    @classmethod
    def handle_aes_input(cls, aes_key, aes_data, decryptor):
        if not isinstance(aes_data.vtype, pm.AesTensorType):
            raise TypeError(
                f"expected AesTensorType input, found {aes_data.vtype}"
            )
        if not aes_data.vtype.dtype.is_fixedpoint:
            raise TypeError("AES tensor payload must be fixed-point")
        if not isinstance(aes_key.vtype, pm.AesKeyType):
            raise TypeError(
                f"expected AesKeyType input, found {aes_key.vtype}"
            )
        with decryptor:
            return pm.decrypt(aes_key, aes_data)

    def aes_predictor_factory(
        self, fixedpoint_dtype=utils.DEFAULT_FIXED_DTYPE
    ):
        """The AES-input computation: alice supplies the ciphertext, the
        replicated placement the key; the model runs on the decrypted
        sharing and bob receives the prediction."""

        def build():
            @pm.computation
            def predictor(
                aes_data: pm.Argument(
                    self.alice,
                    vtype=pm.AesTensorType(dtype=fixedpoint_dtype),
                ),
                aes_key: pm.Argument(
                    self.replicated, vtype=pm.AesKeyType()
                ),
            ):
                x = self.handle_aes_input(
                    aes_key, aes_data, decryptor=self.replicated
                )
                with self.replicated:
                    pred = self.predictor_fn(x, fixedpoint_dtype)
                return self.handle_output(
                    pred, prediction_handler=self.bob
                )

            return predictor

        return self._memoized(("aes", fixedpoint_dtype), build)


def AesWrapper(inner_model_cls):
    """Extend a predictor class with AES-encrypted input handling: the
    mixin's methods take precedence over the inner class's ``__call__``
    while everything else (from_onnx, predictor_fn, weights) is
    inherited unchanged."""
    return type(
        f"Aes{inner_model_cls.__name__}",
        (AesInputMixin, inner_model_cls),
        {},
    )
