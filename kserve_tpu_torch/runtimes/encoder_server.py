"""Encoder runtime: embeddings, rerank, classification and fill-mask on
the port's BERT stack (port of kserve_tpu/runtimes/encoder_server.py).

It speaks both protocol families: the OpenAI `/embeddings` and `/rerank`
routes, and V1 / V2 predict for classification (the argmax label) and
fill-mask (the argmax token at every position of the bucket, padded ones
included, as the reference answers).  Sequence lengths are bucketed (16,
32, ..., 512, capped at --max_length) as the reference's jitted programs
are; here a bucket only bounds the padding.  Computation is f32 on the
device; products never run in TF32 (PyTorch's default, which this module
leaves as it is).

Entrypoint:
    python -m kserve_tpu_torch.runtimes.encoder_server --model_name=bert \\
        --model_dir=/mnt/models --task=embedding

The model runs on cuda unless --device cpu is given; without CUDA and
without --device cpu it raises.
"""

from __future__ import annotations

import argparse
import base64
import logging
import os
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device, upload
from ..engine.tokenizer import load_tokenizer
from ..errors import InferenceError, InvalidInput
from ..infer_type import InferRequest
from ..model import Model
from ..model_server import ModelServer
from ..models import bert
from ..protocol.openai.openai_model import OpenAIEncoderModel
from ..protocol.openai.types import (
    Embedding,
    EmbeddingObject,
    EmbeddingRequest,
    Rerank,
    RerankRequest,
    RerankResult,
    RerankResultDocument,
    UsageInfo,
)
from ..utils.inference import get_predict_response

TASKS = ("embedding", "rerank", "classification", "fill_mask")
_BUCKETS = (16, 32, 64, 128, 256, 512)
NAMED_CONFIGS = {"tiny": bert.BertConfig.tiny, "bert-base": bert.BertConfig}


class TorchEncoderModel(Model, OpenAIEncoderModel):
    """A BERT encoder served over the OpenAI embeddings and rerank routes
    and V1 / V2 predict.  Random weights are drawn from seed 0, as the
    reference draws them from PRNGKey(0)."""

    def __init__(
        self,
        name: str,
        model_dir: Optional[str] = None,
        config: Optional[bert.BertConfig] = None,
        task: str = "embedding",
        random_weights: bool = False,
        max_length: int = 512,
        device=None,
    ):
        super().__init__(name)
        if task not in TASKS:
            raise ValueError(f"unknown task {task!r}; expected one of {TASKS}")
        self.device = resolve_device(device)
        self.model_dir = model_dir
        self.config = config
        self.task = task
        self.random_weights = random_weights
        self.max_length = max_length
        self.tokenizer = None
        self.params: Optional[bert.Params] = None

    def load(self) -> bool:
        if self.config is None:
            cfg_path = os.path.join(self.model_dir or "", "config.json")
            if not os.path.exists(cfg_path):
                raise FileNotFoundError(f"no config.json under {self.model_dir}")
            self.config = bert.BertConfig.from_hf_config(cfg_path)
        self.tokenizer = load_tokenizer(self.model_dir, self.config.vocab_size)
        if self.random_weights or not self.model_dir:
            self.params = bert.init_params(self.config, 0, self.device)
        else:
            self.params = bert.load_hf_weights(self.model_dir, self.config, self.device)
        self.ready = True
        return True

    # ---------------- tokenization ----------------

    def _bucket(self, n: int) -> int:
        for b in _BUCKETS:
            if n <= b and b <= self.max_length:
                return b
        return self.max_length

    def _batch_encode(self, texts: List[str], pairs: Optional[List[str]] = None):
        """(ids, mask, token types) as int64 numpy [B, bucket]: each text's
        ids cut at max_length, a pair's second text (token type 1) in the
        room left."""
        encoded = []
        type_ids = []
        for i, text in enumerate(texts):
            ids = self.tokenizer.encode(text, add_bos=False)[: self.max_length]
            types = [0] * len(ids)
            if pairs is not None:
                second = self.tokenizer.encode(pairs[i], add_bos=False)
                room = self.max_length - len(ids)
                ids = ids + second[:room]
                types = types + [1] * len(second[:room])
            encoded.append(ids)
            type_ids.append(types)
        longest = self._bucket(max(len(e) for e in encoded))
        B = len(encoded)
        input_ids = np.zeros((B, longest), np.int64)
        mask = np.zeros((B, longest), np.int64)
        types_arr = np.zeros((B, longest), np.int64)
        for i, (ids, types) in enumerate(zip(encoded, type_ids)):
            n = min(len(ids), longest)
            input_ids[i, :n] = ids[:n]
            mask[i, :n] = 1
            types_arr[i, :n] = types[:n]
        return input_ids, mask, types_arr

    def _run(self, fn, *arrays) -> np.ndarray:
        """`fn(params, config, *tensors)` on the device, as numpy."""
        with torch.inference_mode():
            tensors = [upload(a, self.device, torch.long) for a in arrays]
            return fn(self.params, self.config, *tensors).cpu().numpy()

    # ---------------- OpenAI verbs ----------------

    async def create_embedding(self, request: EmbeddingRequest, headers=None) -> Embedding:
        inputs = request.input
        if isinstance(inputs, str):
            inputs = [inputs]
        if not inputs or not isinstance(inputs[0], str):
            raise InvalidInput("embedding input must be a string or list of strings")
        ids, mask, _ = self._batch_encode(list(inputs))
        vectors = self._run(bert.embed, ids, mask)
        if request.dimensions:
            vectors = vectors[:, : request.dimensions]
        data = []
        for i, vec in enumerate(vectors):
            if request.encoding_format == "base64":
                payload = base64.b64encode(vec.astype(np.float32).tobytes()).decode()
            else:
                payload = [float(x) for x in vec]
            data.append(EmbeddingObject(index=i, embedding=payload))
        n_tokens = int(mask.sum())
        return Embedding(data=data, model=request.model,
                         usage=UsageInfo(prompt_tokens=n_tokens, total_tokens=n_tokens))

    async def create_rerank(self, request: RerankRequest, headers=None) -> Rerank:
        if not request.documents:
            raise InvalidInput("rerank requires documents")
        ids, mask, types = self._batch_encode(
            [request.query] * len(request.documents), request.documents)
        logits = self._run(bert.classify, ids, mask, types)
        # cross-encoder convention: a single logit is the score, else the
        # positive (last) class's
        scores = logits[:, 0] if logits.shape[1] == 1 else logits[:, -1]
        order = np.argsort(-scores)
        if request.top_n:
            order = order[: request.top_n]
        results = [
            RerankResult(
                index=int(i), relevance_score=float(scores[i]),
                document=(RerankResultDocument(text=request.documents[i])
                          if request.return_documents else None))
            for i in order
        ]
        n_tokens = int(mask.sum())
        return Rerank(results=results, model=request.model,
                      usage=UsageInfo(prompt_tokens=n_tokens, total_tokens=n_tokens))

    # ---------------- V1/V2 predict (classification / fill-mask) ----------------

    async def predict(self, payload, headers=None, response_headers=None):
        if isinstance(payload, InferRequest):
            texts = payload.inputs[0].as_string()
        else:
            texts = payload.get("instances") or payload.get("inputs")
        if not isinstance(texts, list) or not texts or not isinstance(texts[0], str):
            raise InvalidInput("expected a list of strings")
        try:
            ids, mask, types = self._batch_encode(texts)
            if self.task == "fill_mask":
                result = self._run(_mlm_argmax, ids, mask)
            else:
                result = self._run(_label_argmax, ids, mask, types)
            return get_predict_response(payload, result, self.name)
        except InvalidInput:
            raise
        except Exception as e:
            raise InferenceError(str(e))


def _mlm_argmax(params, config, ids, mask):
    """The argmax token of every position, taken on the device: the
    logits of a 32 x 512 batch would be 2 GB on the host."""
    return bert.fill_mask_logits(params, config, ids, mask).argmax(dim=-1)


def _label_argmax(params, config, ids, mask, types):
    return bert.classify(params, config, ids, mask, types).argmax(dim=-1)


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model_name", default="model")
    parser.add_argument("--model_dir", default="/mnt/models")
    parser.add_argument("--http_port", default=8080, type=int)
    parser.add_argument("--task", default="embedding", choices=TASKS)
    parser.add_argument("--random_weights", action="store_true")
    parser.add_argument("--max_length", default=512, type=int)
    parser.add_argument("--model_config", default=None, choices=sorted(NAMED_CONFIGS))
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; no fall back to the CPU")
    return parser


def build_model(args) -> TorchEncoderModel:
    """The model the command line describes (kserve_tpu/runtimes/
    encoder_server.py:206-229): a named config, else the directory's
    config.json, else BERT-base shapes; random weights without a
    directory."""
    config = NAMED_CONFIGS[args.model_config]() if args.model_config else None
    model_dir = args.model_dir if os.path.isdir(args.model_dir) else None
    if config is None and model_dir is None:
        config = bert.BertConfig()
    return TorchEncoderModel(
        args.model_name, model_dir=model_dir, config=config, task=args.task,
        random_weights=args.random_weights, max_length=args.max_length,
        device=args.device)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = build_arg_parser().parse_args(argv)
    model = build_model(args)
    model.load()
    ModelServer(http_port=args.http_port).start([model])


if __name__ == "__main__":
    main()
