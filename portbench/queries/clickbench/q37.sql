SELECT "Title", COUNT(*) AS c FROM hits
WHERE "CounterID" = 62 AND "EventDate" >= date '2013-07-01'
  AND "EventDate" <= date '2013-07-31' AND "DontCountHits" = 0
  AND "IsRefresh" = 0 AND "Title" <> ''
GROUP BY "Title" ORDER BY c DESC LIMIT 10
