"""Typed HTTP request/response values (counterpart of
``io/http/schema.py:22-160``, the part the server uses).

Slotted dataclasses; ``to_dict``/``from_dict`` give the JSON-shaped form
the reference uses on the wire and in persistence, so both packages
read each other's records.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

__all__ = ["HeaderData", "EntityData", "StatusLineData", "HTTPRequestData",
           "HTTPResponseData"]


@dataclass
class HeaderData:
    name: str
    value: str

    def to_dict(self):
        return {"name": self.name, "value": self.value}

    @staticmethod
    def from_dict(d):
        return HeaderData(d["name"], d["value"])


@dataclass
class EntityData:
    """Body bytes + content metadata."""
    content: bytes = b""
    content_encoding: Optional[HeaderData] = None
    content_length: Optional[int] = None
    content_type: Optional[HeaderData] = None
    is_chunked: bool = False
    is_repeatable: bool = True
    is_streaming: bool = False

    @staticmethod
    def from_string(s: str, content_type: str = "application/json") -> "EntityData":
        b = s.encode("utf-8")
        return EntityData(content=b, content_length=len(b),
                          content_type=HeaderData("Content-Type", content_type))

    def string_content(self) -> str:
        return self.content.decode("utf-8", errors="replace")

    def to_dict(self):
        return {
            "content": self.content.decode("latin-1"),
            "contentEncoding": self.content_encoding.to_dict() if self.content_encoding else None,
            "contentLength": self.content_length,
            "contentType": self.content_type.to_dict() if self.content_type else None,
            "isChunked": self.is_chunked,
            "isRepeatable": self.is_repeatable,
            "isStreaming": self.is_streaming,
        }

    @staticmethod
    def from_dict(d):
        return EntityData(
            content=d.get("content", "").encode("latin-1"),
            content_encoding=HeaderData.from_dict(d["contentEncoding"])
            if d.get("contentEncoding") else None,
            content_length=d.get("contentLength"),
            content_type=HeaderData.from_dict(d["contentType"])
            if d.get("contentType") else None,
            is_chunked=d.get("isChunked", False),
            is_repeatable=d.get("isRepeatable", True),
            is_streaming=d.get("isStreaming", False),
        )


@dataclass
class StatusLineData:
    protocol_version: str = "HTTP/1.1"
    status_code: int = 200
    reason_phrase: str = "OK"

    def to_dict(self):
        return {"protocolVersion": self.protocol_version,
                "statusCode": self.status_code,
                "reasonPhrase": self.reason_phrase}

    @staticmethod
    def from_dict(d):
        return StatusLineData(d.get("protocolVersion", "HTTP/1.1"),
                              d["statusCode"], d.get("reasonPhrase", ""))


@dataclass
class HTTPRequestData:
    """Method, URL, headers and entity of one request."""
    url: str = ""
    method: str = "GET"
    headers: List[HeaderData] = field(default_factory=list)
    entity: Optional[EntityData] = None

    @staticmethod
    def from_json(url: str, payload, method: str = "POST",
                  headers: Optional[List[HeaderData]] = None) -> "HTTPRequestData":
        return HTTPRequestData(
            url=url, method=method, headers=list(headers or []),
            entity=EntityData.from_string(json.dumps(payload)))

    def header_map(self) -> dict:
        h = {hd.name: hd.value for hd in self.headers}
        if self.entity and self.entity.content_type:
            h.setdefault(self.entity.content_type.name, self.entity.content_type.value)
        return h

    def to_dict(self):
        return {"url": self.url, "method": self.method,
                "headers": [h.to_dict() for h in self.headers],
                "entity": self.entity.to_dict() if self.entity else None}

    @staticmethod
    def from_dict(d):
        return HTTPRequestData(
            url=d.get("url", ""), method=d.get("method", "GET"),
            headers=[HeaderData.from_dict(h) for h in d.get("headers", [])],
            entity=EntityData.from_dict(d["entity"]) if d.get("entity") else None)


@dataclass
class HTTPResponseData:
    headers: List[HeaderData] = field(default_factory=list)
    entity: Optional[EntityData] = None
    status_line: StatusLineData = field(default_factory=StatusLineData)
    locale: str = "en_US"

    @property
    def status_code(self) -> int:
        return self.status_line.status_code

    def string_content(self) -> str:
        return self.entity.string_content() if self.entity else ""

    def json_content(self):
        return json.loads(self.string_content())

    def to_dict(self):
        return {"headers": [h.to_dict() for h in self.headers],
                "entity": self.entity.to_dict() if self.entity else None,
                "statusLine": self.status_line.to_dict(),
                "locale": self.locale}

    @staticmethod
    def from_dict(d):
        return HTTPResponseData(
            headers=[HeaderData.from_dict(h) for h in d.get("headers", [])],
            entity=EntityData.from_dict(d["entity"]) if d.get("entity") else None,
            status_line=StatusLineData.from_dict(d["statusLine"]),
            locale=d.get("locale", "en_US"))
