"""OpenAI-protocol model bases (port of kserve_tpu/protocol/openai/
openai_model.py:30-59).

`OpenAIModel` marks a model the OpenAI routes serve; `OpenAIGenerativeModel`
adds completions and chat, `OpenAIEncoderModel` embeddings and rerank.  The
REST server looks a verb up on the model itself (protocol/rest/server.py
`_openai_model`), so a handle with the verb's method serves it without
subclassing, and a model without it answers 400 "does not support this
endpoint", as the JAX data plane's isinstance check does.
"""

from __future__ import annotations

from ...model import BaseModel


class OpenAIModel(BaseModel):
    """Marker base of the models the /openai/v1 routes serve."""


class OpenAIGenerativeModel(OpenAIModel):
    async def create_completion(self, request, headers=None):
        raise NotImplementedError()

    async def create_chat_completion(self, request, headers=None):
        raise NotImplementedError()


class OpenAIEncoderModel(OpenAIModel):
    async def create_embedding(self, request, headers=None):
        raise NotImplementedError()

    async def create_rerank(self, request, headers=None):
        raise NotImplementedError()
