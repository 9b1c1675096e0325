"""AWS SQS pub/sub driver — from-scratch REST client (no boto).

Port of kubeai_tpu/messenger/sqs_driver.py: the JAX package's code,
its imports in this package.

The reference rides gocloud.dev's awssnssqs driver
(ref: internal/manager/run.go:47-53); the wire surface actually used by
the messenger is four calls — SendMessage, ReceiveMessage (long poll),
DeleteMessage (Ack), ChangeMessageVisibility(0) (Nack → immediate
redelivery) — spoken here over SQS's JSON protocol
(`X-Amz-Target: AmazonSQS.<Op>`, `Content-Type: application/x-amz-json-1.0`)
with SigV4 request signing implemented directly (hmac/sha256 stdlib).

URL form (gocloud-compatible):
    awssqs://sqs.us-east-2.amazonaws.com/123456789012/myqueue?region=us-east-2

Env:
    AWS_ACCESS_KEY_ID / AWS_SECRET_ACCESS_KEY / AWS_SESSION_TOKEN  creds
    AWS_REGION                       default region when ?region= absent
    AWS_ENDPOINT_URL_SQS             endpoint override (tests/localstack;
                                     also downgrades to unsigned requests
                                     when no creds are set)
Message bodies are base64-encoded on the wire (SQS constrains payloads
to valid UTF-8; request envelopes are JSON but responses can be bytes).
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import json
import os
import urllib.error
import urllib.parse
import urllib.request

from kubeai_tpu_torch.messenger.drivers import Message, Subscription, Topic


def _sigv4_headers(
    method: str, url: str, region: str, body: bytes, amz_target: str
) -> dict[str, str]:
    """SigV4 signature for an SQS JSON-protocol request (public signing
    recipe; service name 'sqs'). Returns the headers to send. Unsigned
    (fake/localstack) when no credentials are configured."""
    parsed = urllib.parse.urlsplit(url)
    now = datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    headers = {
        "Content-Type": "application/x-amz-json-1.0",
        "X-Amz-Target": amz_target,
        "X-Amz-Date": amz_date,
        "Host": parsed.netloc,
    }
    access_key = os.environ.get("AWS_ACCESS_KEY_ID", "")
    secret_key = os.environ.get("AWS_SECRET_ACCESS_KEY", "")
    if not access_key or not secret_key:
        return headers
    token = os.environ.get("AWS_SESSION_TOKEN")
    if token:
        headers["X-Amz-Security-Token"] = token

    signed_names = sorted(h.lower() for h in headers)
    canonical_headers = "".join(
        f"{name}:{headers[next(h for h in headers if h.lower() == name)].strip()}\n"
        for name in signed_names
    )
    signed_headers = ";".join(signed_names)
    payload_hash = hashlib.sha256(body).hexdigest()
    canonical_request = "\n".join(
        [
            method,
            urllib.parse.quote(parsed.path or "/"),
            parsed.query,
            canonical_headers,
            signed_headers,
            payload_hash,
        ]
    )
    scope = f"{datestamp}/{region}/sqs/aws4_request"
    string_to_sign = "\n".join(
        [
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(canonical_request.encode()).hexdigest(),
        ]
    )

    def hm(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = hm(("AWS4" + secret_key).encode(), datestamp)
    k = hm(k, region)
    k = hm(k, "sqs")
    k = hm(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
    headers["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}"
    )
    return headers


class _SqsClient:
    def __init__(self, ref: str):
        # ref = "sqs.us-east-2.amazonaws.com/1234/myqueue?region=us-east-2"
        if "?" in ref:
            ref, query = ref.split("?", 1)
            params = dict(urllib.parse.parse_qsl(query))
        else:
            params = {}
        self.region = params.get("region") or os.environ.get("AWS_REGION", "us-east-1")
        endpoint = os.environ.get("AWS_ENDPOINT_URL_SQS")
        host, _, path = ref.partition("/")
        if endpoint:
            self.queue_url = endpoint.rstrip("/") + "/" + path
        else:
            self.queue_url = f"https://{host}/{path}"

    def call(self, op: str, payload: dict) -> dict:
        body = json.dumps(payload).encode()
        target = f"AmazonSQS.{op}"
        headers = _sigv4_headers("POST", self.queue_url, self.region, body, target)
        req = urllib.request.Request(self.queue_url, data=body, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=70) as resp:
                data = resp.read()
        except urllib.error.HTTPError as e:
            raise RuntimeError(f"sqs {op} failed: HTTP {e.code}: {e.read()[:300]!r}") from e
        return json.loads(data) if data.strip() else {}


class SqsTopic(Topic):
    def __init__(self, ref: str):
        self._client = _SqsClient(ref)

    def send(self, body: bytes) -> None:
        # gocloud's awssnssqs convention (the reference's driver): UTF-8-
        # safe bodies go raw; only binary payloads are base64-encoded,
        # flagged via the `base64encoded` message attribute. Sniffing on
        # receive instead would corrupt a raw text message that happens
        # to be valid base64 (advisor r3), and unconditional encoding
        # would be unreadable to reference consumers.
        payload: dict = {"QueueUrl": self._client.queue_url}
        try:
            text = body.decode("utf-8")
        except UnicodeDecodeError:
            text = None
        # SQS rejects bodies with valid-UTF-8 characters outside its
        # permitted set (#x9 #xA #xD #x20-#xD7FF #xE000-#xFFFD
        # #x10000-#x10FFFF) with InvalidMessageContents — treat those
        # like binary too, not just undecodable bytes.
        if text is not None and all(
            c in "\t\n\r"
            or 0x20 <= ord(c) <= 0xD7FF
            or 0xE000 <= ord(c) <= 0xFFFD
            or 0x10000 <= ord(c) <= 0x10FFFF
            for c in text
        ):
            payload["MessageBody"] = text
        else:
            payload["MessageBody"] = base64.b64encode(body).decode()
            payload["MessageAttributes"] = {
                "base64encoded": {"DataType": "String", "StringValue": "true"}
            }
        self._client.call("SendMessage", payload)


class SqsSubscription(Subscription):
    def __init__(self, ref: str):
        self._client = _SqsClient(ref)
        self._closed = False

    def receive(self, timeout: float | None = None) -> Message | None:
        wait = min(int(timeout) if timeout is not None else 20, 20)
        out = self._client.call(
            "ReceiveMessage",
            {
                "QueueUrl": self._client.queue_url,
                "MaxNumberOfMessages": 1,
                "WaitTimeSeconds": max(wait, 0),
                "MessageAttributeNames": ["base64encoded"],
            },
        )
        msgs = out.get("Messages") or []
        if not msgs:
            return None
        m = msgs[0]
        receipt = m["ReceiptHandle"]
        # Decode ONLY when the producer flagged the body as base64
        # (gocloud's convention) — content sniffing would corrupt a raw
        # text message that happens to be valid base64 (advisor r3).
        attrs = m.get("MessageAttributes") or {}
        if "base64encoded" in attrs:
            body = base64.b64decode(m["Body"])
        else:
            body = m["Body"].encode()

        def ack():
            self._client.call(
                "DeleteMessage",
                {"QueueUrl": self._client.queue_url, "ReceiptHandle": receipt},
            )

        def nack():
            # Visibility 0 => immediately re-receivable (gocloud's Nack).
            self._client.call(
                "ChangeMessageVisibility",
                {
                    "QueueUrl": self._client.queue_url,
                    "ReceiptHandle": receipt,
                    "VisibilityTimeout": 0,
                },
            )

        return Message(body, ack=ack, nack=nack)
