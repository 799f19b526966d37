"""HTTP-on-DataFrame (counterpart of ``mmlspark_tpu/io/http/``): the
request/response values (``schema.py``), pooled and bounded-concurrency
clients with the reference's retry ladder on the standard library
(``clients.py``), the input/output parsers and the ``HTTPTransformer`` /
``SimpleHTTPTransformer`` stages. Host work: a service stage keeps the
network busy while the card's pipeline streams on.
"""

from .schema import (EntityData, HeaderData, HTTPRequestData,
                     HTTPResponseData, StatusLineData)
from .clients import (AsyncHTTPClient, SingleThreadedHTTPClient,
                      advanced_handler, basic_handler, send_with_retries)
from .parsers import (CustomInputParser, CustomOutputParser, JSONInputParser,
                      JSONOutputParser, StringOutputParser)
from .http_transformer import HTTPTransformer, SimpleHTTPTransformer

__all__ = [
    "HeaderData", "EntityData", "StatusLineData", "HTTPRequestData",
    "HTTPResponseData", "send_with_retries", "advanced_handler",
    "basic_handler", "SingleThreadedHTTPClient", "AsyncHTTPClient",
    "JSONInputParser", "CustomInputParser", "JSONOutputParser",
    "StringOutputParser", "CustomOutputParser", "HTTPTransformer",
    "SimpleHTTPTransformer",
]
