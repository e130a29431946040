SELECT "URL", COUNT(*) AS c FROM hits
WHERE "CounterID" = 62 AND "EventDate" >= date '2013-07-01'
  AND "EventDate" <= date '2013-07-31' AND "DontCountHits" = 0
  AND "IsRefresh" = 0 AND "URL" <> ''
GROUP BY "URL" ORDER BY c DESC LIMIT 10
